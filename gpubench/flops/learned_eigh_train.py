"""Operations and bytes of one training step of upstream's published
ADMM-Net (ten layers, eigh GLayers, the attention head), counted from a
fixed formula at the logical side m = n + 1 = 101, as
``flops.learned_eigh_deploy`` counts the deployment.

- forward, per GLayer: the eigensolve, 36 m^3 a matrix, and the rebuild
  V diag(f(w)) V^H, one complex m^3 product (8 m^3);
- backward, per GLayer: M_bar = V diag(w_bar) V^H (one complex product,
  8 m^3) and the rebuild's gradient G_bar V (one complex product, 8 m^3:
  V is detached, so no product is made for it);
- the head: its forward as in the deployment, its backward twice that.

The trunk runs num_layers - 1 GLayers; its other steps are elementwise
and counted by none.  The bytes are the eigensolves' (M in, w and V
out)."""

from __future__ import annotations

from gpubench.flops.learned_eigh_deploy import eigh_bytes, eigh_flops, head_flops, rebuild_flops


def per_call(config: dict, traffic: dict) -> dict:
    """{part: (operations, bytes)}: one GLayer's eigensolve of the batch, its
    rebuild, its backward (M_bar and the rebuild's gradient), the head's
    forward and the whole step."""
    spec, model = config["spec"], config["model"]
    B = traffic["batch"]
    m = spec["Nb"] * spec["Nd"] + 1
    eigh = (eigh_flops(B, m), eigh_bytes(B, m))
    rebuild = (rebuild_flops(B, m), 0.0)
    backward = (2 * rebuild_flops(B, m), 0.0)
    head = (head_flops(B, model, spec), 0.0)
    layers = model["num_layers"] - 1
    step = layers * (eigh[0] + rebuild[0] + backward[0]) + 3 * head[0]
    return {"eigh": eigh, "rebuild": rebuild, "backward": backward, "head": head,
            "call": (step, layers * eigh[1])}
