"""Host ms a frame spends inside the scene update's range ("nebulae/refit"), summed over the range's
user_annotation events in the host-traced window (0 where the program opens no such range)."""

NAME = "nebulae/refit"


def read(run):
    if run["kind"] != "frames" or run.get("trace") is None:
        return None
    return sum(end - start for start, end in run["trace"].ranges(NAME)) / run["count"] / 1e3
