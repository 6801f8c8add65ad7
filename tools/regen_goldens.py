"""Regenerate golden-YUV fixtures from the reference decoder oracle.

Usage: python tools/regen_goldens.py   (requires tools/oracle/build_oracle.sh run first)

Writes, under tests/fixtures/:
  ref_qcif_intra_qp28.golden.yuv / ref_qcif_ippp_qp28.golden.yuv /
  ref_qcif_ippp_qp20.golden.yuv  — raw planar 4:2:0 dumps of the reference
  decoder's output on the matching .264 fixture streams
  drugi_frame0.golden.yuv        — frame 0 of the reference decode of drugi.264
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from h264_fer.vio.y4m import Y4MReader

REFDEC = "/tmp/refbuild/refdec"
FIXTURES = pathlib.Path(__file__).parent.parent / "tests/fixtures"
DRUGI = "/root/reference/fer_h264/fer_h264/drugi.264"


def decode_to_raw(stream: str, out: pathlib.Path, max_frames: int | None = None,
                  max_nals: int | None = None) -> int:
    with tempfile.TemporaryDirectory() as td:
        y4m = f"{td}/o.y4m"
        cmd = [REFDEC, stream, y4m]
        if max_nals is not None:
            cmd.append(str(max_nals))
        subprocess.run(cmd, check=True, capture_output=True)
        n = 0
        with open(out, "wb") as fh:
            for y, cb, cr in Y4MReader(y4m, crop_to_mb=False):
                fh.write(y.tobytes() + cb.tobytes() + cr.tobytes())
                n += 1
                if max_frames is not None and n >= max_frames:
                    break
    print(f"{out.name}: {n} frames")
    return n


def main() -> int:
    for name in ("ref_qcif_intra_qp28", "ref_qcif_ippp_qp28", "ref_qcif_ippp_qp20"):
        decode_to_raw(str(FIXTURES / f"{name}.264"), FIXTURES / f"{name}.golden.yuv")
    if pathlib.Path(DRUGI).exists():
        decode_to_raw(DRUGI, FIXTURES / "drugi_frame0.golden.yuv",
                      max_frames=1, max_nals=4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
