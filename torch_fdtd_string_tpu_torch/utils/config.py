"""Hydra-compatible configuration composer (dependency-free).

The package does not depend on Hydra/OmegaConf, so this module
re-implements the subset of Hydra 1.x semantics the reference CLI surface
uses (cf. reference ``run.py:54``, ``src/utils/config.py:126-196``):

  * a config tree rooted at ``configs/config.yaml`` with group directories
    (``experiment/``, ``task/``, ``model/``, ``optimizer/``, ``scheduler/``,
    ``framework/``, ``callbacks/``);
  * ``defaults`` lists with ``_self_``, group choices (``experiment: base``),
    absolute refs (``/model: fdtd``) and bare same-group includes (``fdtd``);
  * ``# @package _global_`` placement;
  * CLI overrides: ``experiment=nsynth-like`` (group choice) and dotted
    ``task.num_samples=100`` value overrides;
  * ``${a.b.c}`` interpolation and ``${now:FORMAT}`` resolver (lenient:
    unresolvable refs become ``"na"``);
  * ``???`` missing markers resolve to ``None`` if never overridden.

The composed config is exposed both as a nested dict and as an
attribute-access object so task code reads ``args.task.batch_size`` exactly
like the reference.
"""

from __future__ import annotations

import copy
import datetime
import os
import re
from typing import Any, Optional

import yaml

MISSING = "???"


class ConfigNode(dict):
    """dict with attribute access (reference run.py:15-28 semantics)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as err:
            raise AttributeError(key) from err

    def __setattr__(self, key, value):
        self[key] = value


def to_node(obj):
    if isinstance(obj, dict):
        return ConfigNode({k: to_node(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [to_node(v) for v in obj]
    return obj


def _deep_merge(base: dict, over: dict) -> dict:
    """Merge ``over`` into ``base`` (dicts merged recursively, rest replaced)."""
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class _Loader(yaml.SafeLoader):
    """SafeLoader with YAML-1.2-style float parsing (``1e-5`` is a float,
    matching OmegaConf/Hydra behaviour; plain YAML 1.1 reads it as a str)."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _load_yaml(path):
    with open(path) as f:
        text = f.read()
    is_global = bool(re.search(r"^#\s*@package\s+_global_", text, re.M))
    data = yaml.load(text, Loader=_Loader) or {}
    return data, is_global


class Composer:
    def __init__(self, config_dir):
        self.config_dir = config_dir
        self.group_choices: dict[str, Optional[str]] = {}

    def _file(self, group, name):
        if group:
            return os.path.join(self.config_dir, group, f"{name}.yaml")
        return os.path.join(self.config_dir, f"{name}.yaml")

    def _compose_file(self, group, name, overrides_choices):
        """Returns the merged *root-level* dict contribution of one file."""
        path = self._file(group, name)
        if not os.path.exists(path):
            raise FileNotFoundError(f"config not found: {path}")
        data, is_global = _load_yaml(path)
        defaults = data.pop("defaults", [])
        own = data

        root = {}
        self_done = False
        for entry in defaults:
            if entry == "_self_":
                root = self._place(root, group, own, is_global)
                self_done = True
                continue
            if isinstance(entry, str):
                # bare include within the same group
                root = _deep_merge(root, self._compose_file(group, entry, overrides_choices))
                continue
            (g, n), = entry.items()
            if n is None:
                continue
            g = g.lstrip("/")
            # CLI group choice wins over the default choice
            n = overrides_choices.get(g, n)
            self.group_choices[g] = n
            root = _deep_merge(root, self._compose_file(g, n, overrides_choices))
        if not self_done:
            root = self._place(root, group, own, is_global)
        return root

    @staticmethod
    def _place(root, group, own, is_global):
        if is_global or not group:
            return _deep_merge(root, own)
        key = group.split("/")[0]
        return _deep_merge(root, {key: own})


def _parse_value(text: str):
    try:
        return yaml.load(text, Loader=_Loader)
    except yaml.YAMLError:
        return text


def _set_dotted(cfg: dict, dotted: str, value):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


_INTERP = re.compile(r"\$\{([^{}]+)\}")


def _resolve(cfg_root, obj, _depth=0):
    if _depth > 10:
        return obj
    if isinstance(obj, dict):
        return {k: _resolve(cfg_root, v, _depth) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve(cfg_root, v, _depth) for v in obj]
    if not isinstance(obj, str):
        return obj
    if obj == MISSING:
        return None

    def repl(m):
        expr = m.group(1)
        if expr.startswith("now:"):
            return datetime.datetime.now().strftime(expr[4:])
        if expr.startswith("eval:"):
            try:
                return str(eval(expr[5:], {}, {}))  # noqa: S307 (reference parity)
            except Exception:
                return "na"
        node: Any = cfg_root
        for part in expr.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                return "na"
        node = _resolve(cfg_root, node, _depth + 1)
        return str(node)

    # full-value interpolation preserves type
    m = _INTERP.fullmatch(obj)
    if m and not any(m.group(1).startswith(p) for p in ("now:", "eval:")):
        node: Any = cfg_root
        for part in m.group(1).split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                node = "na"
                break
        return _resolve(cfg_root, node, _depth + 1)
    return _INTERP.sub(repl, obj)


def compose(config_dir, cli_args=None, config_name="config"):
    """Compose the config tree with CLI overrides.

    ``cli_args``: list like ``["experiment=nsynth-like", "task.num_samples=100"]``.
    Returns a ``ConfigNode``.
    """
    cli_args = list(cli_args or [])
    choices = {}
    dotted = []
    for arg in cli_args:
        if "=" not in arg:
            raise ValueError(f"override must be key=value: {arg}")
        key, val = arg.split("=", 1)
        key = key.lstrip("+")
        if "." not in key and os.path.isdir(os.path.join(config_dir, key)):
            choices[key] = val
        else:
            dotted.append((key, _parse_value(val)))

    composer = Composer(config_dir)
    root = composer._compose_file("", config_name, choices)
    # group choices given on the CLI that config.yaml's defaults didn't cover
    for g, n in choices.items():
        if composer.group_choices.get(g) != n:
            root = _deep_merge(root, composer._compose_file(g, n, choices))
            composer.group_choices[g] = n
    for key, val in dotted:
        _set_dotted(root, key, val)
    root = _resolve(root, root)
    return to_node(root)


def print_config(cfg, path=None, _indent=0, _lines=None):
    """Render the config tree (reference config.py:165-196's role)."""
    top = _lines is None
    if top:
        _lines = []
    for k, v in cfg.items():
        if isinstance(v, dict):
            _lines.append("  " * _indent + f"{k}:")
            print_config(v, None, _indent + 1, _lines)
        else:
            _lines.append("  " * _indent + f"{k}: {v}")
    if top:
        text = "\n".join(_lines)
        print(text)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text
