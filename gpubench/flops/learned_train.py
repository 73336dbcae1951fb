"""Operations and bytes of one training step of the learned net (forward
K5, reversible backward K6 and the head), counted from the algorithm at
the logical side m = n + 1 = 101.

Frozen from the port's chip smoke test (``cheb_flops``, ``cheb_bwd_flops``
and their bytes): the training forward does K4's degree - 1 complex
products per matrix; the reversible backward 3 degree - 3 (three real m^3
products each, 2 operations a multiply-add), reading M, the cotangent, the
four carry planes and the coefficients once and writing the two
cotangents once.  The head's forward is counted as in the deployment and
its backward as twice its forward."""

from __future__ import annotations

from gpubench.flops.learned_deploy import cheb_bytes, cheb_flops, head_flops


def cheb_bwd_flops(B: int, m: int, degree: int) -> float:
    return B * (3 * degree - 3) * 3 * 2.0 * m**3


def cheb_bwd_bytes(B: int, m: int, degree: int) -> float:
    return B * (3 * m * m * 8 + 4 * m * m * 4 + 2 * degree * 4)


def per_call(config: dict, traffic: dict) -> dict:
    """{part: (operations, bytes)}: one GLayer forward, one GLayer backward
    and the whole step."""
    spec, model = config["spec"], config["model"]
    B, d = traffic["batch"], model["cheb_degree"]
    m = spec["Nb"] * spec["Nd"] + 1
    fwd = (cheb_flops(B, m, d), cheb_bytes(B, m, d) + 4 * m * m * 4 * B)
    bwd = (cheb_bwd_flops(B, m, d), cheb_bwd_bytes(B, m, d))
    layers = model["num_layers"] - 1
    head = 3 * head_flops(B, model, spec)
    return {"glayer": fwd, "glayer_bwd": bwd,
            "call": (layers * (fwd[0] + bwd[0]) + head, layers * (fwd[1] + bwd[1]))}
