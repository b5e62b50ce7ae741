"""The qutrit model (counterpart of pygsti_tpu/models/qutrit.py): a qutrit
on the symmetric (triplet) subspace of two qubits, with the idle, XX, YY
and Molmer-Sorensen gates, in the 'qt' basis."""

from __future__ import annotations

import numpy as np
import scipy.linalg as spl

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.tools.basistools import stdmx_to_vec
from pygsti_tpu_torch.tools.optools import unitary_to_superop

# |00>, (|01>+|10>)/sqrt2, (|01>-|10>)/sqrt2, |11>: the qutrit lives on rows 0, 1, 3
_A = np.array([[1, 0, 0, 0],
               [0, 1 / np.sqrt(2), 1 / np.sqrt(2), 0],
               [0, 1 / np.sqrt(2), -1 / np.sqrt(2), 0],
               [0, 0, 0, 1]])
_X = np.array([[0, 1], [1, 0]])
_Y = np.array([[0, -1j], [1j, 0]])


def to_qutrit_space(input_mat):
    """A two-qubit unitary projected onto the symmetric qutrit subspace."""
    m = _A @ np.asarray(input_mat) @ _A.conj().T
    keep = [0, 1, 3]
    return m[np.ix_(keep, keep)]


def _xx_qutrit(theta):
    x = spl.expm(-1j / 2 * theta * _X)
    return to_qutrit_space(np.kron(x, x))


def _yy_qutrit(theta):
    y = spl.expm(-1j / 2 * theta * _Y)
    return to_qutrit_space(np.kron(y, y))


def _ms_qutrit(theta, phi):
    a = np.cos(phi) * _X + np.sin(phi) * _Y
    return to_qutrit_space(spl.expm(-1j / 2 * theta * np.kron(a, a)))


def _random_rot(scale, rand_state):
    rndm = rand_state.rand(3, 3)
    herm = (rndm + rndm.T) / 2 + 1j * 0
    off = rand_state.rand(3, 3)
    herm = herm + 1j * (off - off.T) / 2
    return spl.expm(-1j * scale * herm)


def create_qutrit_model(error_scale, x_angle=np.pi / 2, y_angle=np.pi / 2,
                        ms_global=np.pi / 2, ms_local=0, similarity=False,
                        seed=None, basis='qt', evotype='default'):
    """The qutrit model 'full TP': Gi, Gx (XX), Gy (YY) and Gm
    (Molmer-Sorensen) on qutrit 'T0', each followed (or, with `similarity`,
    conjugated) by a random rotation of scale `error_scale` drawn from
    RandomState(seed); prep |0>, outcomes '0bright', '1bright', '2bright'."""
    from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
    from pygsti_tpu_torch.modelmembers.operations import FullTPOp
    from pygsti_tpu_torch.modelmembers.povms import TPPOVM
    from pygsti_tpu_torch.modelmembers.states import TPState

    gates = [np.identity(3, complex), _xx_qutrit(x_angle), _yy_qutrit(y_angle),
             _ms_qutrit(ms_global, ms_local)]
    rndm = np.random.RandomState(seed)
    # drawn in the JAX package's order: X, Y, M, then I
    Xr, Yr, Mr, Ir = (_random_rot(error_scale, rndm) for _ in range(4))
    rots = [Ir, Xr, Yr, Mr]
    if similarity:
        gates = [r.conj().T @ g @ r for g, r in zip(gates, rots)]
    else:
        gates = [g @ r for g, r in zip(gates, rots)]

    b = Basis.cast(basis, 9)
    mdl = ExplicitOpModel(9, b, 'full TP')

    def vec(diag):
        return np.real(stdmx_to_vec(np.diag(diag).astype(complex), b)).reshape(-1)

    mdl.preps['rho0'] = TPState(vec([1.0, 0, 0]))
    mdl.povms['Mdefault'] = TPPOVM([('0bright', vec([1.0, 0, 0])),
                                    ('1bright', vec([0, 1.0, 0])),
                                    ('2bright', vec([0, 0, 1.0]))])
    for name, u in zip(('Gi', 'Gx', 'Gy', 'Gm'), gates):
        mdl.operations[Label(name, 'T0')] = FullTPOp(np.real(unitary_to_superop(u, b)))
    return mdl
