"""Two-tier run configuration: par files overridden by CLI arguments.

Capability of the reference ``src/include/par_file.h`` + ``par_args.h``:
  * Parameter files are ``name = value`` text, ``#`` comments, whitespace
    tolerant; values may be scalars or space-separated arrays
    (``source = 0 5 1E-3 1.5707``).
  * CLI arguments are ``--key=value`` (note the ``=`` syntax, par_args.h:18);
    every app lets the CLI override the par file per key
    (emissivity.cpp:36-37).
  * Typed getters with required-vs-default semantics: a missing key raises
    unless a default is supplied.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Sequence


# Persistent compilation cache used when JAX_COMPILATION_CACHE_DIR is unset:
# a fixed path inside the checkout, so every process of the checkout hits it.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def compilation_cache_dir() -> str:
    """The persistent compilation cache directory: JAX_COMPILATION_CACHE_DIR
    where it is set (JAX reads it itself), else ``DEFAULT_CACHE_DIR``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def enable_compilation_cache():
    """Turn on JAX's persistent compilation cache (off when RT_COMPCACHE=0).

    Every app main and the chip scripts call this at start-up, so a second
    process reuses the kernels and programs the first one compiled."""
    if os.environ.get("RT_COMPCACHE", "1") == "0":
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


class ParameterError(KeyError):
    """Missing required parameter (par_file.h:20-35)."""


_SENTINEL = object()


def _convert(value: str, typ):
    if typ is bool:
        v = value.strip().lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse boolean from {value!r}")
    if typ is int:
        # tolerate scientific-notation ints ("1E5")
        f = float(value)
        if f != int(f):
            raise ValueError(f"non-integer value {value!r} for int parameter")
        return int(f)
    return typ(value)


class ParameterFile:
    """``name = value`` parameter file (par_file.h:38-206)."""

    def __init__(self, filename: str | None = None, text: str | None = None):
        self._params: dict[str, str] = {}
        if filename is not None:
            with open(filename) as f:
                text = f.read()
        if text is not None:
            for line in text.splitlines():
                line = line.split("#", 1)[0].strip()
                if not line or "=" not in line:
                    continue
                key, _, value = line.partition("=")
                self._params[key.strip()] = value.strip()

    def key_exists(self, key: str) -> bool:
        return key in self._params

    def get(self, key: str, typ=float, default=_SENTINEL):
        if key not in self._params:
            if default is _SENTINEL:
                raise ParameterError(f"required parameter '{key}' not found")
            return default
        return _convert(self._params[key], typ)

    def get_array(self, key: str, typ=float, n: int | None = None):
        if key not in self._params:
            raise ParameterError(f"required parameter '{key}' not found")
        vals = [_convert(v, typ) for v in self._params[key].split()]
        if n is not None and len(vals) < n:
            raise ParameterError(f"parameter '{key}' needs {n} values, got {len(vals)}")
        return vals[:n] if n is not None else vals


class ParameterArgs:
    """``--key=value`` command-line arguments (par_args.h:39-219)."""

    def __init__(self, argv: Sequence[str] | None = None):
        argv = list(sys.argv[1:] if argv is None else argv)
        self._params: dict[str, str] = {}
        self._positional: list[str] = []
        for arg in argv:
            if arg.startswith("--"):
                key, sep, value = arg.partition("=")
                self._params[key] = value if sep else "1"
            else:
                self._positional.append(arg)

    def key_exists(self, key: str) -> bool:
        if not key.startswith("--"):
            key = "--" + key
        return key in self._params

    def get(self, key: str, typ=float, default=_SENTINEL):
        if not key.startswith("--"):
            key = "--" + key
        if key not in self._params:
            if default is _SENTINEL:
                raise ParameterError(f"required argument '{key}' not found")
            return default
        return _convert(self._params[key], typ)

    @property
    def positional(self) -> list[str]:
        return self._positional


class Config:
    """CLI-over-par-file lookup, collapsing the per-app boilerplate the
    reference repeats in every main() (emissivity.cpp:32-55)."""

    def __init__(self, argv: Sequence[str] | None = None, default_parfile: str | None = None):
        self.args = ParameterArgs(argv)
        parfile = (
            self.args.get("parfile", str)
            if self.args.key_exists("parfile")
            else default_parfile
        )
        self.par = ParameterFile(parfile) if parfile else ParameterFile(text="")
        self.parfile = parfile

    def get(self, key: str, typ=float, default=_SENTINEL):
        if self.args.key_exists(key):
            return self.args.get(key, typ)
        if default is _SENTINEL:
            return self.par.get(key, typ)
        return self.par.get(key, typ, default)

    def key_exists(self, key: str) -> bool:
        return self.args.key_exists(key) or self.par.key_exists(key)

    def get_array(self, key: str, typ=float, n: int | None = None):
        # CLI overrides the par file here too: --source="0 5 1e-3 0"
        if self.args.key_exists(key):
            vals = [_convert(v, typ) for v in self.args.get(key, str).split()]
            if n is not None and len(vals) < n:
                raise ParameterError(
                    f"parameter '{key}' needs {n} values, got {len(vals)}")
            return vals[:n] if n is not None else vals
        return self.par.get_array(key, typ, n)
