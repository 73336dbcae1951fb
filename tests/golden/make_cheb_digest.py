"""Write cheb_fwd_digest.json: the SHA-256 digests of K4's and K5's output
planes on the fixed inputs of ``card_checks.cheb_fwd_digests``, computed by
the CUDA kernel of the tree this file sits in.  Needs a CUDA device.

The card test ``test_cheb_fwd_kernel_bits`` holds the kernel to these
digests.  Run from the repository root:

    python tests/golden/make_cheb_digest.py [--out PATH]
"""

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))

from card_checks import CHEB_BIT_DEGREE, cheb_fwd_digests  # noqa: E402

from admmnet_tpu_torch.kernels import cheb_filter as kc  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=Path(__file__).with_name("cheb_fwd_digest.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the digests are of the CUDA kernel's output")
    dev = torch.device("cuda", 0)
    doc = {"degree": CHEB_BIT_DEGREE, "device": torch.cuda.get_device_name(dev),
           "digests": cheb_fwd_digests(kc, dev)}
    args.out.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
