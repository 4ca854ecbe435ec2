"""Share of the traced serving window in which no operation ran on the card."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
