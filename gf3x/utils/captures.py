"""Frozen-capture manifest helpers (tests/fixtures/manifest.json).

One place turns a manifest entry into the decode config, so the capture
regression tests and the on-card parity check (chip_smoke.py) can never
drift apart on how optional fields (today: the SPEC §5b `bit_loading`
out-of-band table) are applied."""

from __future__ import annotations

from ..config import ModemConfig, preset

__all__ = ["capture_config"]


def capture_config(cap: dict) -> ModemConfig:
    """Manifest capture entry → the config its WAV must be decoded with."""
    cfg = preset(cap["preset"])
    if "bit_loading" in cap:
        cfg = cfg.replace(bit_loading=tuple(cap["bit_loading"]))
    return cfg
