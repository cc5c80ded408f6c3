"""What the entries share: the configuration's trace semantics, the
program's light source, and the outcome of a TraceResult."""

from __future__ import annotations

import numpy as np

# the warm call's seed is the run's plus this: no window call uses it
WARM_OFFSET = 1 << 40

# directivities a configuration may name, as the program's source takes them
DIRECTIVITY = {
    "isotropic": None,
    "cos_polar": lambda az, pol: np.cos(pol),
}


def opts(config: dict) -> dict:
    """The semantics the reference follows, from the configuration."""
    sem = dict(config["semantics"])
    sem["iterations"] = int(config["call"]["trace_iterations"])
    sem["hist_center"] = tuple(sem["hist_center"])
    return sem


def program_overrides(config: dict) -> dict:
    """The same semantics as the program's TraceConfig fields."""
    sem = config["semantics"]
    return dict(trace_iterations=int(config["call"]["trace_iterations"]),
                eps=sem["eps"], eps_bary=sem["eps_bary"],
                dissipation_target=sem["dissipation_target"],
                hist_azimuth_bins=sem["hist_azimuth_bins"],
                hist_polar_bins=sem["hist_polar_bins"],
                hist_center=tuple(sem["hist_center"]))


def program_source(light: dict, ray_count: int, seed: int):
    """The program's own source object for the configuration's light."""
    from lightpycl_tpu_torch.sources import CollimatedSource, light_source

    if light["kind"] == "point":
        return light_source(center=tuple(light["center"]),
                            direction=tuple(light["direction"]),
                            directivity=DIRECTIVITY[light["directivity"]],
                            power=light["power"], ray_count=ray_count,
                            seed=seed)
    if light["kind"] == "collimated":
        return CollimatedSource(center=tuple(light["center"]),
                                direction=tuple(light["direction"]),
                                diameter=light["diameter"],
                                power=light["power"], ray_count=ray_count,
                                seed=seed)
    raise ValueError(f"unknown light kind {light['kind']!r}")


def outcome(ledger: dict, live: float, per_detector, hist, power: float):
    """Shares of the power emitted (the emitted power itself as a share
    of the source's `power`)."""
    e = max(ledger["emitted"], 1e-30)
    led = {k: ledger[k] / e for k in ("measured", "absorbed", "escaped",
                                      "culled")}
    led["live"] = live / e
    led["emitted"] = ledger["emitted"] / power
    return {"ledger": led,
            "per_detector": np.asarray(per_detector, np.float64) / e,
            "hist": None if hist is None else np.asarray(hist, np.float64) / e}


def kept(result) -> dict:
    """What the check needs of a TraceResult."""
    return {"ledger": dict(result.ledger),
            "live": float(result.final_live_power),
            "per_detector": np.array(result.per_detector, np.float64),
            "hist": np.array(result.hist, np.float64)}
