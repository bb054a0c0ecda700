"""Dataclass → argparse bridge with real type resolution.

Builds a CLI from a settings dataclass the way the reference's scripts
expose their full flag surface (``mae/main_pretrain.py:48-135``), but with
the types derived from the dataclass annotations instead of guessed from
defaults:

* ``Optional[int] / Optional[float] / Optional[str]`` cast to the inner
  type (``--save-freq-mins 5`` parses as ``5.0``, not the string ``"5"``);
* ``bool`` / ``Optional[bool]`` accept an optional explicit value —
  ``--norm-pix-loss`` means True, ``--norm-pix-loss false`` (or 0/no/off)
  means False — so boolean defaults can be turned off from the CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import typing
from typing import Any, Optional, Type

__all__ = ["parse_bool", "add_dataclass_arguments", "parse_into_dataclass"]

_TRUE = {"1", "true", "yes", "on", "t", "y"}
_FALSE = {"0", "false", "no", "off", "f", "n"}


def parse_bool(text: str) -> bool:
    lowered = str(text).strip().lower()
    if lowered in _TRUE:
        return True
    if lowered in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {text!r}")


def _unwrap_optional(annotation: Any) -> Any:
    if typing.get_origin(annotation) is typing.Union:
        non_none = [a for a in typing.get_args(annotation) if a is not type(None)]
        if len(non_none) == 1:
            return non_none[0]
    return annotation


def add_dataclass_arguments(parser: argparse.ArgumentParser, cls: Type) -> None:
    hints = typing.get_type_hints(cls)
    for field in dataclasses.fields(cls):
        name = "--" + field.name.replace("_", "-")
        annotation = _unwrap_optional(hints.get(field.name, str))
        if annotation is bool:
            parser.add_argument(
                name, type=parse_bool, nargs="?", const=True,
                default=field.default, metavar="BOOL",
            )
        elif annotation in (int, float, str):
            parser.add_argument(name, type=annotation, default=field.default)
        else:
            parser.add_argument(name, type=str, default=field.default)


def parse_into_dataclass(
    cls: Type,
    argv: Optional[list] = None,
    description: Optional[str] = None,
) -> Any:
    parser = argparse.ArgumentParser(description=description)
    add_dataclass_arguments(parser, cls)
    args = parser.parse_args(argv)
    return cls(**vars(args))
