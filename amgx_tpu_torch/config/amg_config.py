"""AMGConfig — scoped configuration (reference AMG_Config, amg_config.h:126).

A copy of the JAX package's parser, kept in this package so the port
imports nothing of it: the same JSON string parses the same way in both.

Supports the three reference input formats (amg_config.cu:60-250):

  * JSON config_version 2 with nested solver scopes — the shipped
    ``src/configs/*.json`` format.  A nested dict valued key like
    ``"preconditioner": {"solver": "AMG", "scope": "amg", ...}`` flattens
    to parameter ``preconditioner = "AMG"`` in the parent scope with the
    dict's remaining entries stored under scope ``"amg"``; looking the
    parameter up returns ``(value, new_scope)`` so nested solvers resolve
    their own parameters (amg_config.h:186-187).
  * legacy comma/semicolon ``k=v`` strings with ``scope:k=v`` and
    ``k(new_scope)=v`` scope declarations (config_version 2 strings).
  * plain ``k=v`` (config_version 1) — everything in the default scope.

Lookup order for get(name, scope): (scope, name) -> ("default", name) ->
registry default.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

from amgx_tpu_torch.config import params as P


class ConfigError(ValueError):
    pass


class AMGConfig:
    def __init__(self):
        # (scope, name) -> value
        self._values: Dict[Tuple[str, str], Any] = {}
        # (scope, name) -> scope the named sub-solver reads its params from
        self._scope_links: Dict[Tuple[str, str], str] = {}
        self._auto_scope = 0

    # -- construction ------------------------------------------------------

    @classmethod
    def from_file(cls, path) -> "AMGConfig":
        with open(path) as f:
            text = f.read()
        return cls.from_string(text)

    @classmethod
    def from_string(cls, text: str) -> "AMGConfig":
        cfg = cls()
        cfg.parse(text)
        return cfg

    @classmethod
    def from_dict(cls, d: dict) -> "AMGConfig":
        cfg = cls()
        cfg._parse_json(d)
        return cfg

    def parse(self, text: str):
        text = text.strip()
        if text.startswith("{"):
            try:
                self._parse_json(json.loads(text))
            except json.JSONDecodeError as e:
                raise ConfigError(f"bad JSON config: {e}") from None
        else:
            self._parse_kv_string(text)

    # -- JSON config_version 2 (amg_config.cu:60-110) ----------------------

    def _parse_json(self, d: dict):
        ver = d.get("config_version", 1)
        if ver not in (1, 2):
            raise ConfigError(f"unsupported config_version {ver}")
        for key, val in d.items():
            if key == "config_version":
                continue
            self._ingest(key, val, scope="default")

    def _ingest(self, key: str, val: Any, scope: str):
        if isinstance(val, dict):
            # a nested solver dict without an explicit scope gets its own
            # auto scope — flattening into the parent would clobber the
            # parent's parameters (reference behavior: unnamed nested
            # scopes are unique)
            child_scope = val.get("scope")
            if child_scope is None:
                self._auto_scope += 1
                child_scope = f"_auto_scope_{self._auto_scope}"
            solver_name = val.get("solver")
            if solver_name is None:
                raise ConfigError(
                    f"nested config for {scope}:{key} lacks 'solver'"
                )
            self._set(scope, key, solver_name)
            self._scope_links[(scope, key)] = child_scope
            for k2, v2 in val.items():
                if k2 == "scope":
                    continue
                if k2 == "solver" and not isinstance(v2, dict):
                    self._set(child_scope, "solver", v2)
                    continue
                self._ingest(k2, v2, scope=child_scope)
        else:
            self._set(scope, key, val)

    # -- legacy k=v strings (amg_config.cu:147-250) ------------------------

    def _parse_kv_string(self, text: str):
        import re

        for item in re.split(r"[,;\n]+", text):
            item = item.strip()
            if not item or item.startswith("#") or item.startswith("%"):
                continue
            if "=" not in item:
                raise ConfigError(f"bad config entry {item!r}")
            lhs, rhs = (s.strip() for s in item.split("=", 1))
            scope = "default"
            new_scope = None
            if ":" in lhs:
                scope, lhs = (s.strip() for s in lhs.split(":", 1))
            if lhs == "config_version":
                if rhs not in ("1", "2"):
                    raise ConfigError(f"unsupported config_version {rhs}")
                continue
            m = re.match(r"^(\w+)\((\w+)\)$", lhs)
            if m:
                lhs, new_scope = m.group(1), m.group(2)
            self._set(scope, lhs, rhs, coerce=True)
            if new_scope is not None:
                self._scope_links[(scope, lhs)] = new_scope

    # -- storage -----------------------------------------------------------

    def _set(self, scope: str, name: str, value: Any, coerce: bool = False):
        desc = P.PARAMS.get(name)
        if desc is None:
            raise ConfigError(
                f"unknown parameter {name!r} (scope {scope!r})"
            )
        if coerce and isinstance(value, str):
            value = _coerce(value, desc.type)
        if desc.type is float and isinstance(value, int):
            value = float(value)
        if desc.type is int and isinstance(value, bool):
            value = int(value)
        if not isinstance(value, desc.type):
            raise ConfigError(
                f"parameter {name!r} expects {desc.type.__name__}, got "
                f"{value!r}"
            )
        if desc.allowed and value not in desc.allowed:
            raise ConfigError(
                f"parameter {name!r} value {value!r} not in {desc.allowed}"
            )
        P.warn_if_na(name)
        self._values[(scope, name)] = value

    def set(self, name: str, value: Any, scope: str = "default"):
        self._set(scope, name, value)

    # -- lookup ------------------------------------------------------------

    def get(self, name: str, scope: str = "default"):
        if (scope, name) in self._values:
            return self._values[(scope, name)]
        if ("default", name) in self._values:
            return self._values[("default", name)]
        return P.get_description(name).default

    def get_scoped(self, name: str, scope: str = "default"):
        """Returns (value, new_scope) like the reference getParameter
        (amg_config.h:186-187): new_scope is where the named sub-solver's
        own parameters live."""
        value = self.get(name, scope)
        if (scope, name) in self._scope_links:
            return value, self._scope_links[(scope, name)]
        if (scope, name) in self._values:
            return value, scope
        if ("default", name) in self._scope_links:
            return value, self._scope_links[("default", name)]
        return value, scope

    def has(self, name: str, scope: str = "default") -> bool:
        return (scope, name) in self._values or (
            "default",
            name,
        ) in self._values

    def items(self):
        return dict(self._values)

    def content_hash(self, digest_size: int = 12) -> str:
        """Stable content hash of the full config identity — the
        config half of every hierarchy-reuse key (serve cache entries,
        store manifests).  Process-independent: sorted items, repr'd
        values.  Scope LINKS are part of the hash: two configs with
        identical key/value maps but different sub-solver scope
        resolution build different hierarchies and must never share a
        persisted setup."""
        import hashlib

        items = sorted(
            (str(scope), str(name), repr(value))
            for (scope, name), value in self._values.items()
        )
        h = hashlib.blake2b(digest_size=digest_size)
        for scope, name, value in items:
            h.update(f"{scope}\0{name}\0{value}\1".encode())
        for (scope, name), child in sorted(self._scope_links.items()):
            h.update(f"L\0{scope}\0{name}\0{child}\1".encode())
        return h.hexdigest()

    # -- persistence (setup-store manifests) -------------------------------

    def to_state(self) -> dict:
        """JSON-able snapshot of the full scoped key/value map (values
        are str/int/float/bool by construction — ``_set`` type-checks
        against the parameter registry)."""
        return {
            "values": [
                [scope, name, value]
                for (scope, name), value in sorted(self._values.items())
            ],
            "scope_links": [
                [scope, name, child]
                for (scope, name), child in sorted(
                    self._scope_links.items()
                )
            ],
            "auto_scope": self._auto_scope,
        }

    @classmethod
    def from_state(cls, state: dict) -> "AMGConfig":
        """Inverse of :meth:`to_state`.  Values re-enter through
        ``_set`` so an edited/corrupted manifest still gets the
        registry's type and allowed-value checks."""
        cfg = cls()
        for scope, name, value in state.get("values", ()):
            cfg._set(str(scope), str(name), value)
        for scope, name, child in state.get("scope_links", ()):
            cfg._scope_links[(str(scope), str(name))] = str(child)
        cfg._auto_scope = int(state.get("auto_scope", 0))
        return cfg

    def __repr__(self):
        return f"AMGConfig({len(self._values)} values)"


def _coerce(s: str, t: type):
    if t is str:
        return s
    try:
        if t is int:
            return int(s)
        if t is float:
            return float(s)
    except ValueError:
        pass
    raise ConfigError(f"cannot coerce {s!r} to {t.__name__}")
