"""Run configurations: a small attribute dict with dotted overrides."""

from __future__ import annotations

import ast


class Config(dict):
    """A nested dict whose keys read and write as attributes.

    ``override("train.beta=25")`` sets a leaf that exists, parsing the value
    as a Python literal and keeping the leaf's type (a string leaf takes the
    text as it is). ``to_dict()`` returns plain nested dicts."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Config) else v for k, v in self.items()}

    def override(self, assignment: str) -> None:
        key, sep, text = assignment.partition("=")
        if not sep:
            raise ValueError(f"override {assignment!r} is not key=value")
        *parents, leaf = key.strip().split(".")
        node = self
        for p in parents:
            node = node[p]
            if not isinstance(node, Config):
                raise KeyError(f"{key}: {p!r} is not a section")
        if leaf not in node or isinstance(node[leaf], Config):
            raise KeyError(f"unknown config key {key!r}")
        old = node[leaf]
        if isinstance(old, str):
            value = text
        else:
            value = ast.literal_eval(text)
            if isinstance(old, bool) != isinstance(value, bool) or not isinstance(
                    value, (type(old), int) if isinstance(old, float) else type(old)):
                raise TypeError(f"{key}: {text!r} is not a {type(old).__name__}")
            value = type(old)(value)
        node[leaf] = value
