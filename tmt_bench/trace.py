"""What the per-layer readers take from a traced run's profiled episode
(``harness.profiled_episode``): device time by operation, the device's
busy time, and its idle gaps named by what the harness was doing."""

from __future__ import annotations

import json
import os

from .stats import idle_gaps, union_length

NOT_KERNELS = ("memcpy", "memset")
PORT_KERNELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "metrics", "port_kernels.json")


def port_kernels() -> tuple:
    """Substrings of the device names of the program's hand-written kernels
    K1-K5, as the benchmark's own ``metrics/port_kernels.json`` lists them."""
    with open(PORT_KERNELS) as f:
        return tuple(json.load(f)["kernels"])


def is_port_kernel(name: str, port: tuple) -> bool:
    return any(k in name for k in port)


def is_kernel(name: str) -> bool:
    low = name.lower()
    return not any(w in low for w in NOT_KERNELS)


def device_s_by_name(profile: dict) -> dict:
    """Seconds on the device by operation name, over the episode."""
    out = {}
    for name, s, e in profile["ops"]:
        out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out


def busy_s(profile: dict) -> float:
    """Seconds in which some operation ran on the device: the union of
    their intervals."""
    return union_length([(s, e) for _, s, e in profile["ops"]]) / 1e6


def _label(profile: dict, label: str, t: int) -> str:
    if label == "step":
        return "autoreset_step" if profile["step_done"][t] else "env_step"
    return label


def gaps(profile: dict):
    """[(what the harness was doing, seconds)] of every stretch of the
    episode in which the device ran nothing, longest first: the span
    (``draw``, ``env_step``, ``autoreset_step``) that holds the gap's
    middle, or ``harness`` between spans."""
    spans = profile["spans"]
    if not spans:
        return []
    start = min(s for _, _, s, _ in spans)
    end = max([e for _, _, _, e in spans] + [e for _, _, e in profile["ops"]])
    out = []
    for s, e in idle_gaps([(s, e) for _, s, e in profile["ops"]], start, end):
        mid = (s + e) / 2
        who = next((_label(profile, lb, t) for lb, t, a, b in spans if a <= mid < b), "harness")
        out.append((who, (e - s) / 1e6))
    return sorted(out, key=lambda g: -g[1])
