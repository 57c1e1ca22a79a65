"""Window seconds over the frames completed in it, in ms."""


def read(run):
    if run["kind"] != "frames" or not run["count"]:
        return None
    return run["seconds"] / run["count"] * 1e3
