"""K4's share of its roofline: the bound from the traced batches' candidates
over conf and rows kept (``work.k4_bound_s``, image by image) over the
device time of the frozen table's K4 family."""

from portbench.work import k4_bound_s


def read(run):
    t = run.trace
    device_s = t["families"].get("K4_nms_suppress", 0.0)
    least = k4_bound_s(t["valid"], t["kept"])
    if not device_s or not least:  # no kernel, or no candidate for it to suppress
        return None
    return 100.0 * least / device_s
