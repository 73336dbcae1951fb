"""Operations and bytes of one call of the learned deployment (the net-3
forward and its spectrum head), counted from the algorithm at the logical
side m = n + 1 = 101.

Frozen from the port's chip smoke test (``cheb_flops``, ``cheb_bytes``):
a GLayer's Clenshaw evaluation does degree - 1 complex products (three
real m^3 products each, 2 operations a multiply-add) per matrix, the
recurrence's first product being with b_1 = 0; it reads M (complex64) and
the coefficients once and writes G once.  The trunk runs num_layers - 1
GLayers (the last depth runs its Phi step only).  The head does two
complex products on its coarse grid and two per refine round and peak, 8
real operations a complex multiply-add."""

from __future__ import annotations


def cheb_flops(B: int, m: int, degree: int) -> float:
    return B * (degree - 1) * 3 * 2.0 * m**3


def cheb_bytes(B: int, m: int, degree: int) -> float:
    return B * (2 * m * m * 8 + degree * 4)


def head_flops(B: int, model: dict, spec: dict) -> float:
    M, N, K = spec["Nb"], spec["Nd"], spec["L_max"]
    cells = round(1.0 / model["head_grid_step"])  # nx = ny
    P = model["head_refine_points"]
    coarse = cells * M * N + cells * N * cells
    refine = model["head_refine_rounds"] * K * (P * M * N + P * N * P)
    return B * 8.0 * (coarse + refine)


def per_call(config: dict, traffic: dict) -> dict:
    """{part: (operations, bytes)}: one GLayer forward and the whole call."""
    spec, model = config["spec"], config["model"]
    B = traffic["batch"]
    m = spec["Nb"] * spec["Nd"] + 1
    glayer = (cheb_flops(B, m, model["cheb_degree"]), cheb_bytes(B, m, model["cheb_degree"]))
    layers = model["num_layers"] - 1
    head = head_flops(B, model, spec)
    return {"glayer": glayer,
            "call": (layers * glayer[0] + head, layers * glayer[1])}
