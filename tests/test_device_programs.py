"""The device frame programs are plain XLA: no hand-written kernel call
is traced into them."""

import functools

import jax
import numpy as np
import pytest

from h264_fer.codec.device_iframe import device_i16_frame_impl
from h264_fer.codec.device_pframe import device_p_frame_impl

W, H, QP, QPC = 64, 48, 28, 28


def _planes(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (H, W)).astype(np.uint8),
            rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8),
            rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8))


def _i_frame():
    fn = functools.partial(device_i16_frame_impl, wmb=W // 16, hmb=H // 16,
                           qp=QP, qpc=QPC)
    return fn, _planes(0)


def _p_frame():
    fn = functools.partial(device_p_frame_impl, wmb=W // 16, hmb=H // 16,
                           window=8, qp=QP, qpc=QPC, cfg_maxdiff=-1,
                           prefilter=True)
    prev_mv = np.zeros(((W // 16) * (H // 16), 4, 2), np.int32)
    return fn, (*_planes(1), *_planes(2), prev_mv)


@pytest.mark.parametrize("program", [_i_frame, _p_frame],
                         ids=["device_i16_frame", "device_p_frame"])
def test_program_has_no_pallas_call(program):
    fn, args = program()
    text = str(jax.make_jaxpr(fn)(*args))
    assert "pallas_call" not in text
    assert "scan[" in text or "while[" in text  # the wavefront loop
