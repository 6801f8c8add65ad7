"""Transform/quant unit tests against golden outputs of the reference codec.

The fixture `transform_golden.bin` is raw int32 LE produced by running the
reference's own transform functions (quantizationTransform.cpp /
scaleTransform.cpp, compiled unmodified) on deterministic pseudorandom
inputs; see tools/oracle/README.md for the generator. Every function must
match bit-exactly, on NumPy and on jax.numpy (CPU backend).
"""

import numpy as np
import pytest

from h264_fer.ops import transform as T
from h264_fer.ops.tables import LEVEL_QUANTIZE, LEVEL_SCALE

QPS = [0, 8, 14, 23, 24, 28, 35, 36, 40, 51]
NB = 64


@pytest.fixture(scope="module")
def golden(fixtures_dir):
    raw = np.fromfile(fixtures_dir / "transform_golden.bin", dtype="<i4")
    pos = [0]

    def take(n, shape):
        out = raw[pos[0] : pos[0] + n].reshape(shape).astype(np.int32)
        pos[0] += n
        return out

    sec1 = []
    for _ in range(NB):
        r = take(16, (4, 4))
        d = take(16, (4, 4))
        per_qp = []
        for _ in QPS:
            c = take(16, (4, 4))
            cq = take(16, (4, 4))
            dd = take(16, (4, 4))
            rr = take(16, (4, 4))
            per_qp.append((c, cq, dd, rr))
        sec1.append((r, d, per_qp))
    sec2 = []
    for _ in range(NB):
        dc = take(16, (4, 4))
        fdc = take(16, (4, 4))
        per_qp = [(take(16, (4, 4)), take(16, (4, 4))) for _ in QPS]
        sec2.append((dc, fdc, per_qp))
    sec3 = []
    for _ in range(NB):
        dc = take(4, (2, 2))
        fdc = take(4, (2, 2))
        per_qp = [(take(4, (2, 2)), take(4, (2, 2))) for _ in QPS]
        sec3.append((dc, fdc, per_qp))
    assert pos[0] == raw.size
    return sec1, sec2, sec3


def test_forward_transform_matches_reference(golden):
    sec1, _, _ = golden
    r = np.stack([b[0] for b in sec1])
    d = np.stack([b[1] for b in sec1])
    np.testing.assert_array_equal(T.forward_transform_4x4(r), d)


@pytest.mark.parametrize("qi", range(len(QPS)))
def test_quant_dequant_inverse_matches_reference(golden, qi):
    sec1, _, _ = golden
    qp = QPS[qi]
    d = np.stack([b[1] for b in sec1])
    c_g = np.stack([b[2][qi][0] for b in sec1])
    cq_g = np.stack([b[2][qi][1] for b in sec1])
    dd_g = np.stack([b[2][qi][2] for b in sec1])
    rr_g = np.stack([b[2][qi][3] for b in sec1])
    np.testing.assert_array_equal(T.quantize_residual(d, qp, False), c_g)
    np.testing.assert_array_equal(T.quantize_residual(d, qp, True), cq_g)
    np.testing.assert_array_equal(T.scale_residual(c_g, qp, False), dd_g)
    np.testing.assert_array_equal(T.inverse_transform_4x4(dd_g), rr_g)


@pytest.mark.parametrize("qi", range(len(QPS)))
def test_dc_luma_matches_reference(golden, qi):
    _, sec2, _ = golden
    qp = QPS[qi]
    dc = np.stack([b[0] for b in sec2])
    fdc = np.stack([b[1] for b in sec2])
    c_g = np.stack([b[2][qi][0] for b in sec2])
    inv_g = np.stack([b[2][qi][1] for b in sec2])
    np.testing.assert_array_equal(T.forward_hadamard_dc_luma(dc), fdc)
    np.testing.assert_array_equal(T.quantize_dc_luma(fdc, qp), c_g)
    np.testing.assert_array_equal(T.inverse_dc_luma(c_g, qp), inv_g)


@pytest.mark.parametrize("qi", range(len(QPS)))
def test_dc_chroma_matches_reference(golden, qi):
    _, _, sec3 = golden
    qp = QPS[qi]
    dc = np.stack([b[0] for b in sec3])
    fdc = np.stack([b[1] for b in sec3])
    c_g = np.stack([b[2][qi][0] for b in sec3])
    inv_g = np.stack([b[2][qi][1] for b in sec3])
    np.testing.assert_array_equal(T.forward_hadamard_dc_chroma(dc), fdc)
    np.testing.assert_array_equal(T.quantize_dc_chroma(fdc, qp), c_g)
    np.testing.assert_array_equal(T.inverse_dc_chroma(c_g, qp), inv_g)


def test_jax_matches_numpy(golden):
    """The same ops under jax.numpy + jit must be bit-identical to NumPy."""
    import jax
    import jax.numpy as jnp

    sec1, sec2, sec3 = golden
    r = np.stack([b[0] for b in sec1])
    qp = 28

    def enc(x):
        d = T.forward_transform_4x4(x)
        c = T.quantize_residual(d, qp, False)
        return c, T.inverse_residual(c, qp, False)

    c_np, r_np = enc(r)
    c_j, r_j = jax.jit(enc)(jnp.asarray(r))
    np.testing.assert_array_equal(np.asarray(c_j), c_np)
    np.testing.assert_array_equal(np.asarray(r_j), r_np)

    dc = np.stack([b[0] for b in sec2])
    f_np = T.forward_dc_luma(dc, 35)
    f_j = jax.jit(lambda x: T.forward_dc_luma(x, 35))(jnp.asarray(dc))
    np.testing.assert_array_equal(np.asarray(f_j), f_np)


def test_zigzag_roundtrip():
    rng = np.random.default_rng(0)
    c = rng.integers(-100, 100, size=(7, 4, 4)).astype(np.int32)
    lst = T.zigzag_scan(c)
    assert lst.shape == (7, 16)
    # spec ordering spot check: positions 0..3 are (0,0),(0,1),(1,0),(2,0)
    np.testing.assert_array_equal(lst[:, 0], c[:, 0, 0])
    np.testing.assert_array_equal(lst[:, 1], c[:, 0, 1])
    np.testing.assert_array_equal(lst[:, 2], c[:, 1, 0])
    np.testing.assert_array_equal(lst[:, 3], c[:, 2, 0])
    np.testing.assert_array_equal(T.zigzag_unscan(lst), c)


def test_quant_tables_consistent():
    # LevelQuantize = round(2^15 / LevelScale) — the reference's comment
    # (quantizationTransform.cpp:23) phrases this as "round(reciprocal>>15)".
    recon = np.round((1 << 15) / LEVEL_SCALE.astype(np.float64)).astype(np.int32)
    np.testing.assert_array_equal(recon, LEVEL_QUANTIZE)
