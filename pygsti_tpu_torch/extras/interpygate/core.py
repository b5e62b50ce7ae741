"""Interpolated operations (counterpart of pygsti_tpu/extras/interpygate/core.py).

Given sampled process matrices G(p_k) on a parameter grid (e.g. from a
physics simulation), ``InterpolatedDenseOp`` is a model member whose
parameters are the physical parameters and whose dense superoperator is the
multilinear interpolation of the samples, a torch function of the
parameters on their device: the member stacks into a model's tensors, Tv
and the blocked Jacobian like any other, so a GST fit of such a model fits
the physical parameters directly.
"""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch.modelmembers.operations import LinearOperator, _TensorConstants


class InterpolatedDenseOp(_TensorConstants, LinearOperator):
    """Operation interpolating sampled process matrices over an N-D grid.

    grid_axes: list of 1-D sorted arrays (one per physical parameter).
    samples: ndarray [len(ax0), len(ax1), ..., dim, dim].
    initial_point: starting physical-parameter values (default: the
    middle of each axis).  It has no gauge transform, as in the JAX
    package.
    """

    def __init__(self, grid_axes, samples, initial_point=None):
        samples = np.asarray(samples, dtype=float)
        self.grid_axes = [np.asarray(a, dtype=float) for a in grid_axes]
        self.samples = samples
        if samples.ndim != len(self.grid_axes) + 2 or \
                samples.shape[:-2] != tuple(len(a) for a in self.grid_axes):
            raise ValueError("samples of shape %s do not fit grid axes of lengths %s"
                             % (samples.shape, [len(a) for a in self.grid_axes]))
        if any(len(a) < 2 or np.any(np.diff(a) <= 0) for a in self.grid_axes):
            raise ValueError("each grid axis needs two or more increasing nodes")
        if initial_point is None:
            initial_point = [0.5 * (a[0] + a[-1]) for a in self.grid_axes]
        super().__init__(samples.shape[-1], np.asarray(initial_point, dtype=float))
        for k, a in enumerate(self.grid_axes):
            setattr(self, '_axis%d' % k, a)

    def to_dense(self, v):
        """Multilinear interpolation at physical parameters v (clipped to
        the grid's hull).  Each axis in turn: the cell is found by
        comparisons, which carry no derivative, and the interpolation is
        linear in v inside it, so forward-mode derivatives (Tv) are the
        cell's slopes."""
        out = self._const('samples', v.device, v.dtype)
        for k in range(len(self.grid_axes)):
            ax = self._const('_axis%d' % k, v.device, v.dtype)
            x = torch.clamp(v[k], ax[0], ax[-1])
            # the last node at or below x, but not the last node
            idx = torch.clamp((ax <= x).sum() - 1, 0, ax.shape[0] - 2)
            x0 = ax[idx]
            x1 = ax[idx + 1]
            t = (x - x0) / (x1 - x0)
            out = (1 - t) * out[idx] + t * out[idx + 1]
        return out

    def physical_parameters(self):
        return self.to_vector()

    def _to_nice_serialization(self):
        return {'grid_axes': list(self.grid_axes), 'samples': self.samples,
                'point': self.to_vector()}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls([np.asarray(a) for a in state['grid_axes']], np.asarray(state['samples']),
                   np.asarray(state['point']))


class InterpolatedOpFactory(object):
    """Factory producing InterpolatedDenseOp instances for given label args
    (reference: interpygate factory + opfactory.py pattern)."""

    def __init__(self, grid_axes, samples):
        self.grid_axes = grid_axes
        self.samples = samples

    def create_op(self, args=None, sslbls=None):
        point = [float(a) for a in args] if args else None
        return InterpolatedDenseOp(self.grid_axes, self.samples, point)


# ---------------------------------------------------------------------------
# Physical-process / interpolated-quantity surface (reference:
# extras/interpygate/core.py:80-700).  Serial host-side: the expensive part
# (physics simulation at grid points) is the user's function; interpolation
# uses scipy.
# ---------------------------------------------------------------------------

class _PhysicalBase(object):
    """Common base for user physics models evaluated on parameter grids
    (reference: interpygate/core.py:80)."""

    def __init__(self, num_params, item_shape, aux_shape=None,
                 num_params_evaluated_as_group=0):
        self.num_params = num_params
        self.item_shape = item_shape
        self.aux_shape = aux_shape
        self.num_params_evaluated_as_group = num_params_evaluated_as_group

    def create_aux_info(self, v, comm=None):
        raise NotImplementedError("Derived classes must implement "
                                  "create_aux_info!")

    def create_aux_infos(self, v, grouped_v, comm=None):
        raise NotImplementedError("Derived classes must implement "
                                  "create_aux_infos!")


class PhysicalProcess(_PhysicalBase):
    """A user-defined physical process producing a process (superoperator)
    matrix at each parameter point (reference:
    interpygate.PhysicalProcess:94)."""

    def create_process_matrix(self, v, comm=None):
        raise NotImplementedError("Derived classes must implement "
                                  "create_process_matrix!")

    def create_process_matrices(self, v, grouped_v, comm=None):
        raise NotImplementedError("Derived classes must implement "
                                  "create_process_matrices!")


class PhysicalErrorGenerator(_PhysicalBase):
    """A user-defined physical process producing an error-generator matrix
    at each parameter point (reference:
    interpygate.PhysicalErrorGenerator:106)."""

    def create_errorgen_matrix(self, v, comm=None):
        raise NotImplementedError("Derived classes must implement "
                                  "create_errorgen_matrix!")

    def create_errorgen_matrices(self, v, grouped_v, comm=None):
        raise NotImplementedError("Derived classes must implement "
                                  "create_errorgen_matrices!")


class OpPhysicalProcess(PhysicalProcess):
    """Wrap a LinearOperator as a PhysicalProcess: the process matrix is
    the op's dense matrix at the given parameter vector (reference:
    interpygate.OpPhysicalProcess:118)."""

    def __init__(self, op):
        self.op = op
        super().__init__(op.num_params, (op.dim, op.dim), None, 0)

    def create_process_matrix(self, v, comm=None):
        import copy
        op = copy.deepcopy(self.op)
        op.from_vector(np.asarray(v))
        return op.dense()


class InterpolatedQuantity(object):
    """An array-valued quantity interpolated over a parameter-space region:
    calling with a parameter vector evaluates every element's interpolator
    (reference: interpygate.InterpolatedQuantity:636)."""

    def __init__(self, interpolators, parameter_ranges):
        self.interpolators = np.asarray(interpolators, dtype=object)
        self.parameter_ranges = tuple(parameter_ranges)

    @property
    def qty_shape(self):
        return self.interpolators.shape

    @property
    def num_params(self):
        return len(self.parameter_ranges)

    def __call__(self, v):
        if len(v) != self.num_params:
            raise ValueError("%d parameters given, %d expected" % (len(v), self.num_params))
        if not all(a <= b <= c
                   for b, (a, c) in zip(v, self.parameter_ranges)):
            raise ValueError("Parameter out of range.")
        value = np.zeros(self.qty_shape, 'd')
        for i, interp in enumerate(self.interpolators.flat):
            u = interp(*v)
            value.flat[i] = u.item() if isinstance(u, np.ndarray) else u
        return value


class InterpolatedQuantityFactory(object):
    """Evaluates a function on a rectangular parameter grid and builds an
    InterpolatedQuantity from per-element interpolators (reference:
    interpygate.InterpolatedQuantityFactory:395).  Serial implementation;
    `interpolator_and_args` may be 'linear', 'spline', or a
    (class, kwargs) pair."""

    def __init__(self, fn_to_interpolate, qty_shape=(),
                 parameter_ranges=None, parameter_points=None,
                 num_params_to_evaluate_as_group=0,
                 interpolator_and_args=None):
        if (parameter_ranges is None) == (parameter_points is None):
            raise ValueError("Exactly one of parameter_ranges or parameter_points required")
        self.fn_to_interpolate = fn_to_interpolate
        self._parameter_ranges = parameter_ranges
        self._parameter_points = np.array(parameter_points) \
            if parameter_points is not None else None
        self.qty_shape = tuple(qty_shape)
        self.interpolator_and_args = interpolator_and_args
        self.data = None
        self.points = None

    def compute_data(self, comm=None, mpi_workers_per_process=1,
                     verbosity=0):
        import itertools
        if self._parameter_ranges is not None:
            axes = [np.linspace(a, b, int(n))
                    for (a, b, n) in self._parameter_ranges]
            self.points = np.array(list(itertools.product(*axes)))
        else:
            self.points = self._parameter_points
        vals = [np.asarray(self.fn_to_interpolate(*pt)).reshape(
            self.qty_shape) for pt in self.points]
        self.data = np.stack(vals)
        return self.data

    def build(self, comm=None, mpi_workers_per_process=1, verbosity=0):
        from scipy.interpolate import LinearNDInterpolator, interp1d
        if self.data is None:
            self.compute_data(comm, mpi_workers_per_process, verbosity)
        n_params = self.points.shape[1]
        interpolators = np.empty(self.qty_shape, dtype=object)
        for i in range(int(np.prod(self.qty_shape)) if self.qty_shape
                       else 1):
            y = self.data.reshape(len(self.points), -1)[:, i]
            if n_params == 1:
                f = interp1d(self.points[:, 0], y, kind='linear',
                             fill_value='extrapolate')
                interpolators.flat[i] = \
                    (lambda g: (lambda *v: g(v[0])))(f)
            else:
                f = LinearNDInterpolator(self.points, y, rescale=True)
                interpolators.flat[i] = \
                    (lambda g: (lambda *v: g(*v)))(f)
        if self._parameter_ranges is not None:
            pranges = [(a, b) for (a, b, _) in self._parameter_ranges]
        else:
            pranges = [(self.points[:, k].min(), self.points[:, k].max())
                       for k in range(n_params)]
        return InterpolatedQuantity(interpolators, pranges)
