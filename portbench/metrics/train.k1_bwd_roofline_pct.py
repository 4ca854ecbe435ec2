"""K1 bwd's share of its roofline: the bound from each yat_ad::dcn_backward
call's shapes over the device time of the frozen table's K1_dcn_backward family."""

from portbench.work import dcn_roofline_pct, k1_bwd_bound_s


def read(run):
    return dcn_roofline_pct(run.trace, "yat_ad::dcn_backward", "K1_dcn_backward", k1_bwd_bound_s)
