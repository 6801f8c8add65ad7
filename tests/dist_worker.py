"""Worker for test_dist_multiprocess: one process of a 2-process
jax.distributed CPU cluster running parallel/dist.encode_multihost.

Usage: python dist_worker.py <out_path> <gop_len>
Env: H264_COORD_ADDR / H264_NUM_PROCS / H264_PROC_ID (dist.py contract).
"""

import sys

import numpy as np


def content(w, h, n):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        y = (((xx // 3 + yy // 2 + 5 * i) % 210)
             + rng.integers(0, 8, (h, w))).astype(np.uint8)
        cb = rng.integers(90, 150, (h // 2, w // 2)).astype(np.uint8)
        cr = rng.integers(90, 150, (h // 2, w // 2)).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def main():
    out_path, gop_len = sys.argv[1], int(sys.argv[2])
    import jax

    jax.config.update("jax_platforms", "cpu")
    from h264_fer.parallel.dist import encode_multihost, maybe_init_distributed

    pid, nproc = maybe_init_distributed()
    frames = content(64, 32, 5)
    stream = encode_multihost(frames, 64, 32, 30, gop_len=gop_len)
    if pid == 0:
        with open(out_path, "wb") as f:
            f.write(stream)
    # all processes must reach teardown together
    jax.effects_barrier()
    print(f"worker {pid}/{nproc} done", flush=True)


if __name__ == "__main__":
    main()
