"""Config system: YAML with `_parent_` chaining, dot-path CLI overrides.

The port's own copy of ``level_s2fm_tpu/config.py`` (the port imports
nothing of the JAX package): `--a.b.c=v` dot-path sets, bare `--flag` for
True, `--flag!` for False, recursive dict override, and per-scene nested
overrides accessed via ``opt.data[scene]``, and ``save_options_file``,
which writes the same ``options.yaml`` text as the JAX package's.
"""
from __future__ import annotations

import copy
import os
import random
from typing import Any, Optional

import numpy as np
import yaml


class Opt(dict):
    """Attribute-accessible nested dict (replacement for easydict)."""

    def __init__(self, d: Optional[dict] = None, **kw):
        super().__init__()
        d = dict(d or {})
        d.update(kw)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, Opt):
            return v
        if isinstance(v, dict):
            return Opt(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Opt._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, Opt._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __delattr__(self, k):
        del self[k]

    def deepcopy(self) -> "Opt":
        return Opt(copy.deepcopy(to_plain(self)))


def to_plain(o: Any) -> Any:
    if isinstance(o, dict):
        return {k: to_plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [to_plain(v) for v in o]
    return o


def _merge(base: dict, override: dict) -> dict:
    """Recursively merge override into base (override wins)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml(path: str, default_path: Optional[str] = None) -> dict:
    """Load a YAML file, resolving `_parent_` chains relative to cwd or the
    file's own directory (reference semantics: `utils/options.py:61-74`)."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    parent = cfg.pop("_parent_", default_path)
    if parent is not None:
        if not os.path.exists(parent):
            cand = os.path.join(os.path.dirname(path), os.path.basename(parent))
            if os.path.exists(cand):
                parent = cand
            else:
                cand2 = os.path.join(os.path.dirname(os.path.dirname(path)), parent)
                if os.path.exists(cand2):
                    parent = cand2
        base = load_yaml(parent)
        cfg = _merge(base, cfg)
    return cfg


def parse_value(s: str) -> Any:
    try:
        v = yaml.safe_load(s)
    except Exception:
        return s
    if isinstance(v, str):
        # YAML 1.1 won't parse '5e-4' as float (needs '5.0e-4'); fix that up
        try:
            return int(v)
        except ValueError:
            pass
        try:
            return float(v)
        except ValueError:
            pass
    return v


def set_dotpath(opt: Opt, dotpath: str, value: Any, strict: bool = True):
    """Set opt.a.b.c = value given 'a.b.c'."""
    keys = dotpath.split(".")
    node = opt
    for k in keys[:-1]:
        if k not in node:
            if strict:
                raise KeyError(f"unknown option group {k!r} in {dotpath!r}")
            node[k] = Opt()
        node = node[k]
    if strict and keys[-1] not in node:
        raise KeyError(f"unknown option {dotpath!r}")
    node[keys[-1]] = value


def parse_arguments(argv: list[str]) -> Opt:
    """Parse `--key.sub=val`, `--flag`, `--flag!` CLI arguments."""
    opt_cmd = Opt()
    for arg in argv:
        if not arg.startswith("--"):
            raise ValueError(f"arguments must start with '--': {arg!r}")
        body = arg[2:]
        if "=" not in body:
            if body.endswith("!"):
                set_dotpath(opt_cmd, body[:-1], False, strict=False)
            else:
                set_dotpath(opt_cmd, body, True, strict=False)
        else:
            key, val = body.split("=", 1)
            set_dotpath(opt_cmd, key, parse_value(val), strict=False)
    return opt_cmd


_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BASE = os.path.join(_PKG_ROOT, "configs", "base.yaml")
DEFAULT_PIPELINE = os.path.join(_PKG_ROOT, "configs", "levels2fm.yaml")


def _warn_unknown_keys(base: dict, override: dict, prefix=""):
    """Non-interactive version of the reference's unknown-option safe check
    (`utils/options.py:76-93` asks the user; we print a warning)."""
    known_new = {"yaml", "cpu", "max_views", "refine_again_iters"}
    for k, v in override.items():
        path = f"{prefix}{k}"
        if k not in base and path not in known_new and prefix == "":
            print(f"[config] warning: option {path!r} not in the yaml "
                  "defaults (typo?)")
        elif isinstance(v, dict) and isinstance(base.get(k), dict):
            _warn_unknown_keys(base[k], v, prefix=path + ".")
        elif prefix and k not in base:
            print(f"[config] warning: option {path!r} not in the yaml "
                  "defaults (typo?)")


def build_options(argv: Optional[list[str]] = None, yaml_path: Optional[str] = None) -> Opt:
    """Full option resolution: pipeline defaults <- yaml file <- CLI."""
    opt_cmd = parse_arguments(argv or [])
    yaml_path = yaml_path or opt_cmd.get("yaml", None) or DEFAULT_PIPELINE
    cfg = load_yaml(yaml_path)
    _warn_unknown_keys(cfg, to_plain(opt_cmd))
    opt = Opt(cfg)
    opt = Opt(_merge(to_plain(opt), to_plain(opt_cmd)))
    process_options(opt)
    return opt


def process_options(opt: Opt):
    """Seed + output dir (reference `utils/options.py:94-112`)."""
    if opt.get("seed") is not None:
        random.seed(opt.seed)
        np.random.seed(opt.seed)
    if opt.get("data", None) is not None and opt.data.get("image_size", None):
        opt.H, opt.W = opt.data.image_size
    # an explicit --output_path override wins; otherwise derive
    # output_root/group/name as the reference does
    if not opt.get("output_path", None):
        name = opt.get("name", "run")
        group = opt.get("group", "default")
        opt.output_path = os.path.join(opt.get("output_root", "output"),
                                       str(group), str(name))


def save_options_file(opt: Opt):
    """Persist the resolved options to ``{output_path}/options.yaml``.

    When an options file from an earlier run exists and differs, the diff
    is printed; an interactive stdin is asked whether to override, an
    unattended run overrides it."""
    import difflib
    import sys as _sys
    fname = os.path.join(opt.output_path, "options.yaml")

    def _san(v):
        if isinstance(v, dict):
            return {k: _san(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [_san(x) for x in v]
        if isinstance(v, np.generic):
            return v.item()
        return v

    new_text = yaml.safe_dump(_san(to_plain(opt)), default_flow_style=False, indent=4)
    if os.path.isfile(fname):
        with open(fname) as f:
            old_text = f.read()
        if old_text == new_text:
            print("existing options file found (identical)")
        else:
            print("existing options file found (different from current one):")
            diff = difflib.unified_diff(old_text.splitlines(), new_text.splitlines(),
                                        fromfile="existing", tofile="current", lineterm="")
            for line in list(diff)[:80]:
                print(line)
            if _sys.stdin is not None and _sys.stdin.isatty():
                override = None
                while override not in ("y", "n"):
                    override = input("override? (y/n) ")
                if override == "n":
                    print("safe exiting...")
                    raise SystemExit(0)
            else:
                print("(non-interactive: overriding options file)")
    else:
        print("(creating new options file...)")
    with open(fname, "w") as f:
        f.write(new_text)


def scene_opt(opt: Opt, key: str, default=None):
    """Per-scene override lookup: opt.data[scene].key or default.

    (Reference pattern: `Renderer.py:25-27`, `Initialization.py:53-54`.)
    """
    scene = opt.data.get("scene")
    scene_cfg = opt.data.get(scene, None) if scene else None
    if scene_cfg is not None and scene_cfg.get(key, None) is not None:
        return scene_cfg[key]
    return default
