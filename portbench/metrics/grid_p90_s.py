"""grid_p90_s (s, host clock): the 90th percentile of job latency, from the
call to its arrays on the host, over every job completed in the window
(linear interpolation between order statistics)."""
import statistics


def read(run):
    lat = [j.seconds for j in run.jobs]
    if len(lat) < 2:
        return lat[0] if lat else None
    return statistics.quantiles(lat, n=10, method="inclusive")[-1]
