"""The standard X(pi/2)/Y(pi/2) RPE convention (counterpart of
pygsti_tpu/extras/rpe/rpeconfig_gxpi2_gypi2_00.py).

alpha = rotation angle of the fixed-axis gate (Gx), epsilon = angle of the
loose-axis gate (Gy), theta = tilt between the axes (0 in target).
"""

import numpy as np

from pygsti_tpu_torch.extras.rpe.rpeconfig import RPEconfig

_d = {}
_d['fixed_axis_gate_label'] = 'Gx'
_d['fixed_axis_label'] = 'X'
_d['fixed_axis_target'] = [0, 1, 0, 0]
_d['loose_axis_gate_label'] = 'Gy'
_d['loose_axis_label'] = 'Y'
_d['loose_axis_target'] = [0, 0, 1, 0]
_d['auxiliary_axis_gate_label'] = 'Gz'
_d['auxiliary_axis_label'] = 'Z'
_d['rhoExpressions'] = ["0"]
_d['EExpressions'] = ["1"]
_d['ELabels'] = ["1"]
_d['spamLabelDict'] = {'plus': ('rho0', 'E0'), 'minus': ('rho0', 'remainder')}
_d['up_labels'] = [('1',)]
_d['dn_labels'] = [('0',)]
_d['alpha'] = np.pi / 2
_d['epsilon'] = np.pi / 2
_d['theta'] = 0
_d['new_epsilon_func'] = lambda epsilon: (epsilon / (np.pi / 2)) - 1
_d['alpha_hat_func'] = lambda xhat, yhat, Nx, Ny: np.arctan2(
    (xhat - Nx / 2.) / Nx, -(yhat - Ny / 2.) / Ny)
_d['epsilon_hat_func'] = lambda xhat, yhat, Nx, Ny: np.arctan2(
    (xhat - Nx / 2.) / Nx, -(yhat - Ny / 2.) / Ny)
_d['Phi_hat_func'] = lambda xhat, yhat, Nx, Ny: np.arctan2(
    (xhat - Nx / 2.) / Nx, -(yhat - Ny / 2.) / Ny)
_d['alpha_cos_prep_tuple'] = ()
_d['alpha_cos_germ_tuple'] = ('Gx',)
_d['alpha_cos_meas_tuple'] = ()
_d['alpha_sin_prep_tuple'] = ()
_d['alpha_sin_germ_tuple'] = ('Gx',)
_d['alpha_sin_meas_tuple'] = ('Gx',)
_d['epsilon_cos_prep_tuple'] = ()
_d['epsilon_cos_germ_tuple'] = ('Gy',)
_d['epsilon_cos_meas_tuple'] = ()
_d['epsilon_sin_prep_tuple'] = ()
_d['epsilon_sin_germ_tuple'] = ('Gy',)
_d['epsilon_sin_meas_tuple'] = ('Gy',)
_d['theta_cos_prep_tuple'] = ()
_d['theta_cos_germ_tuple'] = ('Gx', 'Gy', 'Gy', 'Gx', 'Gx', 'Gy', 'Gy', 'Gx')
_d['theta_cos_meas_tuple'] = ()
_d['theta_sin_prep_tuple'] = ()
_d['theta_sin_germ_tuple'] = ('Gx', 'Gy', 'Gy', 'Gx', 'Gx', 'Gy', 'Gy', 'Gx')
_d['theta_sin_meas_tuple'] = ('Gy',)

rpeconfig_gxpi2_gypi2_00 = RPEconfig(_d)
