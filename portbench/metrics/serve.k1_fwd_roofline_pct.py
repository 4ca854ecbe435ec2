"""K1 fwd's share of its roofline in serving: the bound from each
yat_ad::dcn_forward call's shapes over the device time of the frozen table's
K1_dcn_forward family."""

from portbench.work import dcn_roofline_pct, k1_fwd_bound_s


def read(run):
    return dcn_roofline_pct(run.trace, "yat_ad::dcn_forward", "K1_dcn_forward", k1_fwd_bound_s)
