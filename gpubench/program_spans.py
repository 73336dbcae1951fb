"""The program's own spans, as the per-layer readers of the host clock read
them: ``admmnet_tpu_torch.utils.profiling.snapshot()`` once a traced run is
over, which holds the count and host seconds of each span opened while the
profiler recorded.  A program without that registry gives nothing, and its
readers then return None."""


def snapshot() -> dict:
    from admmnet_tpu_torch.utils import profiling

    snap = getattr(profiling, "snapshot", None)
    return snap() if snap is not None else {}


def ms_per(span: str, per: str):
    """Host milliseconds spent in ``span`` per ``per`` span recorded (per
    call of the enclosing span, or per ``span`` itself), None where either
    was not recorded."""
    snap = snapshot()
    n = snap.get(per, {}).get("count", 0)
    if not n or not snap.get(span, {}).get("count", 0):
        return None
    return 1e3 * snap[span]["host_s"] / n
