"""Host synchronisations with the card a step, by torch's sync debug mode,
over one episode of its own after the profiled one."""


def read(run):
    syncs = run["syncs"]
    return None if syncs is None else syncs["syncs"] / syncs["steps"]
