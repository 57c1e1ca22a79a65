"""Window seconds over the train steps completed in it, in ms."""


def read(run):
    if run["kind"] != "steps" or not run["count"]:
        return None
    return run["seconds"] / run["count"] * 1e3
