"""The yardstick's arithmetic and the metric readers on hand-made inputs."""

import math

import numpy as np
import pytest

from gstbench import arith, spec


def test_jacobian_bytes_and_flops_count_each_circuit_at_its_depth():
    # two circuits of depths 2 and 3, d 4, k1 3 (two ops and the identity), 2 outcomes
    nbytes, flops = arith.jacobian_bytes_flops([2, 3], d=4, k1=3, nout=2)
    cols, F, E = 4 * 5, 8 * 5 * 4, 8 * 2 * 2 * 4
    A, Bf, G = 8 * 2 * 2 * (3 - 1) * 16, 8 * 2 * 2 * 4, 8 * 3 * 16
    assert nbytes == cols + F + E + A + Bf + G == 1844
    assert flops == 4 * 2 * 16 * 5 == 640
    assert arith.jacobian_min_seconds([2, 3], 4, 3, 2) == pytest.approx(
        max(1844 / 3.35e12, 640 / 33.5e12), rel=1e-15)


def test_padding_does_not_move_the_count():
    # the same circuits split into other buckets give the same yardstick
    a = arith.jacobian_bytes_flops([5, 7, 70, 3], 16, 7, 4)
    b = arith.jacobian_bytes_flops([70, 3, 7, 5], 16, 7, 4)
    assert a == b


def test_lm_step_flops():
    assert arith.lm_step_flops(10, 3) == 2 * 10 * 9 + 2 * 10 * 3 + 27 / 3 == 249
    # the 2-qubit fit's final list: about 2.9e11 FLOP an iteration
    assert arith.lm_step_flops(55832, 1616) == pytest.approx(2.93e11, rel=1e-2)


@pytest.mark.parametrize('start,end,busy,gaps,after', [
    ([0, 5, 6, 20, 40], [10, 7, 8, 30, 41], 21, [10, 10], [3, 4]),
    ([0, 1, 2], [5, 3, 4], 5, [], []),
    ([0, 10], [10, 20], 20, [], []),
    ([], [], 0, [], []),
])
def test_union_and_gaps(start, end, busy, gaps, after):
    b, g, a = arith.union_and_gaps(np.array(start, np.int64), np.array(end, np.int64))
    assert b == busy and list(g) == gaps and list(a) == after


def _record(trace=True):
    return {'setup_s': 12.5, 'window_s': 10.0, 'outcomes': 2,
            'config': {'num_params': 3, 'dim': 4, 'op_stack': 3},
            'list_depths': [[2, 3], [2, 3, 4]],
            'fits': [{'stages': [{'list': 0, 'iterations': 4}, {'list': 1, 'iterations': 6}],
                      'objfn_build_s': 0.5},
                     {'stages': [{'list': 0, 'iterations': 2}, {'list': 1, 'iterations': 8}],
                      'objfn_build_s': 0.7}],
            'trace': None if not trace else {'window_s': 20.0, 'events': 400, 'busy_s': 5.0,
                                             'kernel_s': 1e-6}}


def read(name, rec):
    return spec.metric_reader(name).read(rec)


def test_end_to_end_readers():
    rec = _record()
    assert read('setup_s', rec) == 12.5
    assert read('fit_s', rec) == 5.0
    assert read('device_step_ms', rec) == pytest.approx(1e3 * 5.0 / 20)


def test_per_layer_readers():
    rec = _record()
    assert read('lm_iters.gst2q', rec) == 10.0
    assert read('lm_step_ms.cloud3q', rec) == pytest.approx(1e3 * 10.0 / 20)
    assert read('objfn_build_s.gst2q', rec) == pytest.approx(0.6)
    assert read('launches_per_step.cloud3q', rec) == 20.0
    assert read('device_idle.gst2q', rec) == 75.0
    flops = 6 * arith.lm_step_flops(4, 3) + 14 * arith.lm_step_flops(6, 3)
    assert read('mfu.gst2q', rec) == pytest.approx(100 * flops / (20.0 * 67e12))
    least = 6 * arith.jacobian_min_seconds([2, 3], 4, 3, 2) \
        + 14 * arith.jacobian_min_seconds([2, 3, 4], 4, 3, 2)
    assert read('bwd_jacobian_roofline.cloud3q', rec) == pytest.approx(100 * least / 1e-6)


def test_readers_return_nothing_without_their_source():
    rec = _record(trace=False)
    for name in ('device_step_ms', 'launches_per_step.gst2q', 'device_idle.cloud3q', 'mfu.gst2q',
                 'bwd_jacobian_roofline.gst2q'):
        assert read(name, rec) is None
    rec['fits'][0]['objfn_build_s'] = rec['fits'][1]['objfn_build_s'] = None
    assert read('objfn_build_s.gst2q', rec) is None
    rec = _record()
    rec['trace']['kernel_s'] = 0.0
    assert read('bwd_jacobian_roofline.gst2q', rec) is None


def test_peaks_are_the_data_sheets():
    assert arith.PEAK_BYTES_PER_S == 3.35e12
    assert arith.PEAK_F64_FLOPS == 33.5e12 and arith.PEAK_F64_TENSOR_FLOPS == 67e12
    assert math.isclose(arith.PEAK_F64_TENSOR_FLOPS, 2 * arith.PEAK_F64_FLOPS)
