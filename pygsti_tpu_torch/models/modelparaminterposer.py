"""Parameter interposers: a linear map between a model's parameter vector
and its members' parameters, host numpy (counterpart of
pygsti_tpu/models/modelparaminterposer.py).

A model with an interposer hands its members w = M v, M the
[member params, model params] transform: its tensors_fn evaluates the
members at M v, and its tensor Jacobian is the members' Jacobian times M.
Going back, a member vector w is the model vector pinv(M) w."""

from __future__ import annotations

import numpy as np


class ModelParamsInterposer(object):
    """Base interposer (reference: modelparaminterposer.py:17)."""

    def __init__(self, num_params, num_op_params):
        self.num_params = num_params
        self.num_op_params = num_op_params

    def model_paramvec_to_ops_paramvec(self, v):
        return v

    def ops_paramvec_to_model_paramvec(self, w):
        return w

    def deriv_op_params_wrt_model_params(self):
        return np.eye(self.num_op_params, self.num_params)


class LinearInterposer(ModelParamsInterposer):
    """w = M v linear interposer (reference:
    modelparaminterposer.LinearInterposer)."""

    def __init__(self, transform_matrix):
        M = np.asarray(transform_matrix)
        super().__init__(M.shape[1], M.shape[0])
        self.transform_matrix = M
        self._pinv = np.linalg.pinv(M)

    def model_paramvec_to_ops_paramvec(self, v):
        return self.transform_matrix @ np.asarray(v)

    def ops_paramvec_to_model_paramvec(self, w):
        return self._pinv @ np.asarray(w)

    def deriv_op_params_wrt_model_params(self):
        return self.transform_matrix
