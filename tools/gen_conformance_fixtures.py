"""Generate CI conformance fixtures from the reference oracle binaries.

Produces (committed under tests/fixtures/conformance/):
  ref_intra_qp{q}.264   — reference encoder output, 2 frames all-intra,
                          for the byte-parity sweep (QP 8..46)
  rd_goldens.json       — reference bytes + mean luma PSNR for the inter
                          RD sweep (QP grid, intra_every=100, 10 frames)

Needs /tmp/refbuild/refenc + refdec (tools/oracle/build_oracle.sh).
"""

import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from h264_fer.vio.y4m import Y4MReader, psnr

ROOT = pathlib.Path(__file__).parent.parent
CLIP = str(ROOT / "tests/fixtures/clip_qcif_10f.y4m")
OUT = ROOT / "tests/fixtures/conformance"
REFDEC = "/tmp/refbuild/refdec"
REFENC = "/tmp/refbuild/refenc"

OUT.mkdir(exist_ok=True)
frames = list(Y4MReader(CLIP))

for qp in (8, 16, 22, 28, 34, 40, 46):
    with tempfile.TemporaryDirectory() as td:
        ref264 = f"{td}/r.264"
        subprocess.run([REFENC, CLIP, ref264, str(qp), "1", "2", "1"],
                       check=True, capture_output=True)
        data = open(ref264, "rb").read()
    (OUT / f"ref_intra_qp{qp}.264").write_bytes(data)
    print(f"intra QP{qp}: {len(data)} bytes")

goldens = {}
for qp in (16, 22, 28, 34, 40, 43, 46):
    with tempfile.TemporaryDirectory() as td:
        ref264 = f"{td}/r.264"
        refy4m = f"{td}/r.y4m"
        subprocess.run([REFENC, CLIP, ref264, str(qp), "1", "10", "100"],
                       check=True, capture_output=True)
        subprocess.run([REFDEC, ref264, refy4m], check=True,
                       capture_output=True)
        gdec = list(Y4MReader(refy4m, crop_to_mb=False))
        nbytes = pathlib.Path(ref264).stat().st_size
    pm = float(np.mean([psnr(d[0], s[0]) for d, s in zip(gdec, frames)]))
    goldens[str(qp)] = {"bytes": nbytes, "psnr": round(pm, 3)}
    print(f"inter QP{qp}: {nbytes} bytes, {pm:.3f} dB")

(OUT / "rd_goldens.json").write_text(json.dumps(goldens, indent=1))
print("wrote", OUT / "rd_goldens.json")
