"""gf3x — an acoustic OFDM modem framework in JAX, run on a GPU.

Brand-new JAX/XLA/Pallas implementation of the capabilities of the reference
`adamg-97/GF3-audio-modem` (see SURVEY.md; the public API contract is
BASELINE.json:5: `encode(bytes) -> waveform`, `decode(waveform) -> bytes`).

    from gf3x import Modem, preset
    modem = Modem(preset("gf3"))
    waveform = modem.encode(b"payload bytes", filename="f.txt")
    result = modem.decode(recording)   # .payload, .filename, .crc_ok, .diag
"""

import os as _os


def compile_cache_dir() -> str:
    """Where JAX's persistent compilation cache lives: the directory that
    `JAX_COMPILATION_CACHE_DIR` names (JAX reads it itself), else
    `<repo>/.jax_cache` beside the package — a fixed path, so a process
    finds what an earlier one compiled."""
    return (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_os.path.dirname(_os.path.dirname(
                _os.path.abspath(__file__))), ".jax_cache"))


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from .config import (ModemConfig, preset, GF3_STANDARD, GF3_FAST,
                     GF3_HICAP, GF3_TURBO, GF3_ROBUST, CONFIG1_LOOPBACK,
                     layout)
from .models import Modem, DecodeDiag, DecodeResult
from .golden import GoldenModem

__version__ = "0.1.0"

__all__ = [
    "ModemConfig",
    "preset",
    "layout",
    "GF3_STANDARD",
    "GF3_FAST",
    "GF3_HICAP",
    "GF3_TURBO",
    "GF3_ROBUST",
    "CONFIG1_LOOPBACK",
    "Modem",
    "DecodeDiag",
    "DecodeResult",
    "GoldenModem",
    "compile_cache_dir",
    "__version__",
]
