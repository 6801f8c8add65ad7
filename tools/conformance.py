"""Extended conformance sweep (needs the oracle + mounted reference).

Usage:
  python tools/conformance.py decode [n_frames]   # drugi.264 sweep vs refdec
  python tools/conformance.py encode              # QP sweep byte-parity + RD

Slower than the test suite; run before closing a round.
"""

from __future__ import annotations

import hashlib
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from h264_fer.codec.decoder import Decoder
from h264_fer.codec.encoder import Encoder, EncoderConfig
from h264_fer.vio.y4m import Y4MReader, psnr

DRUGI = "/root/reference/fer_h264/fer_h264/drugi.264"
REFDEC = "/tmp/refbuild/refdec"
REFENC = "/tmp/refbuild/refenc"
CLIP = str(pathlib.Path(__file__).parent.parent / "tests/fixtures/clip_qcif_10f.y4m")


def cmd_decode(n_frames: int = 100) -> int:
    with tempfile.TemporaryDirectory() as td:
        out = f"{td}/ref.y4m"
        subprocess.run([REFDEC, DRUGI, out, str(n_frames + 2)], check=True,
                       capture_output=True)
        ref_frames = Y4MReader(out, crop_to_mb=False)
        dec = Decoder()
        data = open(DRUGI, "rb").read()
        n_ok = 0
        for mine, ref in zip(dec.decode_annexb(data), ref_frames):
            ok = all((mine[k] == ref[k]).all() for k in range(3))
            if not ok:
                print(f"frame {n_ok}: MISMATCH")
                return 1
            n_ok += 1
            if n_ok % 10 == 0:
                print(f"{n_ok} frames bit-exact...")
        print(f"PASS: {n_ok} frames bit-exact vs reference decoder")
    return 0


def cmd_encode() -> int:
    frames = list(Y4MReader(CLIP))
    rc = 0
    print("intra byte-parity sweep:")
    for qp in (8, 16, 22, 28, 34, 40, 46):
        enc = Encoder(176, 144, EncoderConfig(qp=qp, intra_every=1))
        mine = enc.encode_sequence(frames[:2])
        with tempfile.TemporaryDirectory() as td:
            ref264 = f"{td}/r.264"
            subprocess.run([REFENC, CLIP, ref264, str(qp), "1", "2", "1"],
                           check=True, capture_output=True)
            ref = open(ref264, "rb").read()
        ok = mine == ref[: len(mine)]
        print(f"  QP{qp}: {'byte-identical' if ok else 'DIFFERS'} ({len(mine)}B)")
        rc |= 0 if ok else 1
    print("inter RD sweep (ours vs reference):")
    for qp in (16, 22, 28, 34, 40):
        enc = Encoder(176, 144, EncoderConfig(qp=qp, intra_every=100))
        mine = enc.encode_sequence(frames)
        mydec = list(Decoder().decode_annexb(mine))
        with tempfile.TemporaryDirectory() as td:
            ref264 = f"{td}/r.264"
            refy4m = f"{td}/r.y4m"
            subprocess.run([REFENC, CLIP, ref264, str(qp), "1", "10", "100"],
                           check=True, capture_output=True)
            subprocess.run([REFDEC, ref264, refy4m], check=True,
                           capture_output=True)
            gdec = list(Y4MReader(refy4m, crop_to_mb=False))
            refbytes = pathlib.Path(ref264).stat().st_size
        pm = np.mean([psnr(d[0], s[0]) for d, s in zip(mydec, frames)])
        pr = np.mean([psnr(d[0], s[0]) for d, s in zip(gdec, frames)])
        tag = "WIN" if (len(mine) <= refbytes and pm >= pr) else (
            "ok" if pm - pr > -0.1 else "LOSS")
        print(f"  QP{qp}: mine {len(mine)}B {pm:.2f}dB | "
              f"ref {refbytes}B {pr:.2f}dB  [{tag}]")
    return rc


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "decode"
    if what == "decode":
        sys.exit(cmd_decode(int(sys.argv[2]) if len(sys.argv) > 2 else 100))
    sys.exit(cmd_encode())
