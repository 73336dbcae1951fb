"""Operations and bytes of one call of upstream's published ADMM-Net
deployment (ten layers, eigh GLayers, the attention head), counted from a
fixed formula at the logical side m = n + 1 = 101, so that whatever solves
the eigenproblems is measured against the same work.

- eigh: 36 m^3 real operations a matrix, Golub and Van Loan's 9 n^3 for
  the symmetric QR algorithm with vectors, x4 for complex arithmetic; its
  bytes M in (complex64), w (float32) and V (complex64) out;
- the rebuild V diag(f(w)) V^H: one complex m^3 product, 8 m^3 real
  operations a matrix;
- the head: every Dense layer and the two attention products, 2
  operations a multiply-add; the grid's projections (position, keys,
  values) once a call, the rest a scene.

The trunk runs num_layers - 1 GLayers (the last depth runs its Phi step
only).  The trunk's other steps are elementwise and counted by none."""

from __future__ import annotations


def eigh_flops(B: int, m: int) -> float:
    return B * 36.0 * m**3


def eigh_bytes(B: int, m: int) -> float:
    return B * (2 * m * m * 8 + m * 4)


def rebuild_flops(B: int, m: int) -> float:
    return B * 8.0 * m**3


def head_flops(B: int, model: dict, spec: dict) -> float:
    n, L = spec["Nb"] * spec["Nd"], spec["L_max"]
    h = model["hidden_dim"]
    per_scene = (2 * n * h + h * h  # feat1, feat2
                 + h * h + 2 * n * h + h * h  # query, logits and weighted values, out
                 + h * (h // 2) + (h // 2) * (h // 4) + (h // 4) * (h // 8)  # peak0-2
                 + L * (2 * ((h // 8) * 32 + 32) + (h // 8) * 16 + 16))  # tau, f, conf
    per_call = 2 * h * n + 2 * n * h * h  # the grid's projection, its keys and values
    return 2.0 * (B * per_scene + per_call)


def per_call(config: dict, traffic: dict) -> dict:
    """{part: (operations, bytes)}: one GLayer's eigensolve of the batch, its
    rebuild, the head, and the whole call."""
    spec, model = config["spec"], config["model"]
    B = traffic["batch"]
    m = spec["Nb"] * spec["Nd"] + 1
    eigh = (eigh_flops(B, m), eigh_bytes(B, m))
    rebuild = (rebuild_flops(B, m), 0.0)
    head = (head_flops(B, model, spec), 0.0)
    layers = model["num_layers"] - 1
    return {"eigh": eigh, "rebuild": rebuild, "head": head,
            "call": (layers * (eigh[0] + rebuild[0]) + head[0], layers * eigh[1])}
