"""The gravity kernels' share of their roofline: the least time the card
needs for the pair interactions the traced stretch asked for (counted from
the kernel-wrapper calls: N^2 a full sweep, B N^2 a group window, K N a
predicted-column call; harness/roofline.py), over the device time of the
kernels (gravity_ms_per_step's). Against the published FP32 rate and the
SFU rate at the card's maximum SM clock."""
UNIT = "%"
LAYER = "kernels"
MOVES = "s_per_Myr"
WORKLOADS = ["n1k-ensemble64", "n100k-block"]


def read(ctx):
    from perfbench.harness import roofline, spec

    card = ctx["card"]
    if not card.get("sm_clock_max_hz") or not ctx["pair_calls"]:
        return None
    gravity = spec.load_metric("gravity_ms_per_step").gravity_seconds(ctx)
    if gravity <= 0:
        return None
    bound = roofline.calls_bound_seconds(ctx["pair_calls"], card["sms"],
                                         card["sm_clock_max_hz"])
    return 100.0 * bound / gravity
