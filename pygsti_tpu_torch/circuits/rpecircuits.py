"""RPE circuit construction (counterpart of
pygsti_tpu/circuits/rpecircuits.py). Generic angle-circuit construction
lives in extras/rpe/rpeconstruction; this module adds the legacy fixed
Gx(pi/4)+Gz(pi/2) sequence builders."""

from pygsti_tpu_torch.circuits.circuit import Circuit as _Circuit
from pygsti_tpu_torch.extras.rpe.rpeconstruction import (
    create_rpe_angle_circuit_lists, create_rpe_angle_circuits_dict)
from pygsti_tpu_torch.tools import listtools as _lt


def make_rpe_alpha_str_lists_gx_gz(k_list):
    """Alpha (Z-rotation angle) cosine/sine circuit lists for approx
    X(pi/4), Z(pi/2) gates (reference rpecircuits.py:16)."""
    cos_list, sin_list = [], []
    for k in k_list:
        cos_list.append(_Circuit(
            ('Gi', 'Gx', 'Gx', 'Gz') + ('Gz',) * k
            + ('Gz', 'Gz', 'Gz', 'Gx', 'Gx'),
            stringrep='GiGxGxGzGz^' + str(k) + 'GzGzGzGxGx'))
        sin_list.append(_Circuit(
            ('Gx', 'Gx', 'Gz', 'Gz') + ('Gz',) * k
            + ('Gz', 'Gz', 'Gz', 'Gx', 'Gx'),
            stringrep='GxGxGzGzGz^' + str(k) + 'GzGzGzGxGx'))
    return cos_list, sin_list


def make_rpe_epsilon_str_lists_gx_gz(k_list):
    """Epsilon (X-rotation angle) cosine/sine circuit lists (reference
    rpecircuits.py:69)."""
    cos_list, sin_list = [], []
    for k in k_list:
        cos_list.append(_Circuit(
            ('Gx',) * k + ('Gx',) * 4,
            stringrep='Gx^' + str(k) + 'GxGxGxGx'))
        sin_list.append(_Circuit(
            ('Gx', 'Gx', 'Gz', 'Gz') + ('Gx',) * k + ('Gx',) * 4,
            stringrep='GxGxGzGzGx^' + str(k) + 'GxGxGxGx'))
    return cos_list, sin_list


def make_rpe_theta_str_lists_gx_gz(k_list):
    """Theta (X-Z axes angle) cosine/sine circuit lists (reference
    rpecircuits.py:111)."""
    germ = ('Gz', 'Gx', 'Gx', 'Gx', 'Gx', 'Gz', 'Gz',
            'Gx', 'Gx', 'Gx', 'Gx', 'Gz')
    cos_list, sin_list = [], []
    for k in k_list:
        cos_list.append(_Circuit(
            germ * k + ('Gx',) * 4,
            stringrep='(GzGxGxGxGxGzGzGxGxGxGxGz)^' + str(k) + 'GxGxGxGx'))
        sin_list.append(_Circuit(
            ('Gx', 'Gx', 'Gz', 'Gz') + germ * k + ('Gx',) * 4,
            stringrep='(GxGxGzGz)(GzGxGxGxGxGzGzGxGxGxGxGz)^' + str(k)
            + 'GxGxGxGx'))
    return cos_list, sin_list


def make_rpe_string_list_d(log2k_max):
    """Dict of all RPE cosine/sine circuit lists for alpha, epsilon, theta
    plus the deduplicated union under 'totalStrList' (reference
    rpecircuits.py:157)."""
    k_list = [2 ** k for k in range(log2k_max + 1)]
    a_cos, a_sin = make_rpe_alpha_str_lists_gx_gz(k_list)
    e_cos, e_sin = make_rpe_epsilon_str_lists_gx_gz(k_list)
    t_cos, t_sin = make_rpe_theta_str_lists_gx_gz(k_list)
    total = _lt.remove_duplicates(a_cos + a_sin + e_cos + e_sin
                                  + t_cos + t_sin)
    return {('alpha', 'cos'): a_cos, ('alpha', 'sin'): a_sin,
            ('epsilon', 'cos'): e_cos, ('epsilon', 'sin'): e_sin,
            ('theta', 'cos'): t_cos, ('theta', 'sin'): t_sin,
            'totalStrList': total}
