"""Rounds of the specials cascade's loop a step
(``engine.cascade_stats["rounds"]``, the program's counter), over the
traced window; nothing where the cascade never ran."""


def read(run):
    rounds = run["counters"].get("cascade_rounds")
    return rounds / run["window"]["steps"] if rounds else None
