"""The CPU measurements behind chip_smoke.py's tolerances for the phi
route's golden steps (``PHI_GOLDEN_LOSS_TOL``, ``PHI_GOLDEN_PARAM_TOL``).

Runs chip_smoke's ``phi_golden_steps`` on CPU tensors (the kernels' plain
PyTorch versions) against phinet_train_golden.msgpack: as the card runs
them; with each batch reordered (seeds 0 and 1), which changes only the
order of the sums and so shows how far a correct run may sit from the
golden; and with the learning rate scaled by 1.05, a fault the gate must
see.  Prints, for each, every step's loss error relative to JAX's, the
parameter change error, and the leaves that carry most of it.  Needs no
JAX; takes about a minute.

Run from the repository root: python tests/golden/phinet_golden_gap.py
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke  # noqa: E402


def main():
    cpu = torch.device("cpu")
    for label, kw in (("as on the card", {}), ("batches reordered, seed 0", {"order_seed": 0}),
                      ("batches reordered, seed 1", {"order_seed": 1}),
                      ("lr x 1.05", {"lr_scale": 1.05})):
        losses, gold, err, shares = chip_smoke.phi_golden_steps(cpu, **kw)
        rel = abs(losses - gold) / abs(gold)
        top = sorted(shares.items(), key=lambda kv: -kv[1])[:3]
        print(f"{label}: loss rel err per step {' '.join(f'{e:.3e}' for e in rel)}; parameter "
              f"change error {err:.3e}; largest shares of its square: "
              + ", ".join(f"{k} {v:.3f}" for k, v in top), flush=True)


if __name__ == "__main__":
    main()
