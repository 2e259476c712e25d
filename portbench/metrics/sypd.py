"""sypd: simulated years a wall-clock day, summed over the trajectories
(members count): the window's substeps x dto x members in years, over
the window's seconds in days (CPMIP's SYPD, Balaji et al. 2017)."""

SECONDS_PER_YEAR = 365 * 86400


def read(record):
    if not record.get("on_card"):
        return None
    years = record["substeps"] * record["dto"] * record["members"] \
        / SECONDS_PER_YEAR
    return years / (record["window_s"] / 86400.0)
