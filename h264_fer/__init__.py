"""h264_fer — an H.264 Baseline-profile encoder/decoder on JAX devices.

A JAX/XLA implementation with the full capability envelope of
the FER-H264 reference codec (zoltanmaric/h264-fer): I/P slices, Intra_4x4 /
Intra_16x16 / chroma prediction, quarter-pel motion estimation/compensation,
4x4 integer DCT + Hadamard DC transforms, CAVLC entropy coding, Annex-B NAL
streams, Y4M I/O — plus an in-loop deblocking filter as a superset.

Layout (mirrors SURVEY.md §7's layer plan):
  ops/        batched integer spec math (transforms, quant, intra, MC, SATD)
              written array-module-generically: runs on NumPy (host decoder &
              test oracle) and jax.numpy (jitted device encoder) with identical
              bit-exact results.
  kernels/    device wavefronts and the in-loop filter (lax loops).
  bitstream/  bit reader/writer, Exp-Golomb, CAVLC tables/codec, NAL framing,
              SPS/PPS/slice-header syntax (host side).
  codec/      encoder/decoder session drivers, DPB, GOP logic.
  parallel/   mesh/sharding: MB-row tile sharding + GOP sharding, halo exchange.
  vio/        Y4M/YUV/PPM frame I/O.
"""

__version__ = "0.1.0"
