"""The nearest-hit kernel's launches in the profiled sub-window: the sum
of their least times (`_roofline.bound_s`, against the published peaks)
over the kernel's summed device time, in %. The pairs of a masked launch
are those its cull mask keeps (whole ray block x triangle tile pairs)."""

from perfcells.harness.catalog import load_module

R = load_module("metrics", "_roofline")


def read(ctx):
    p = ctx["profile"]
    if p is None:
        return None
    k = R.kernel_s(p)
    if k <= 0 or not ctx["bounds_s"]:
        return None
    return 100.0 * sum(ctx["bounds_s"]) / k
