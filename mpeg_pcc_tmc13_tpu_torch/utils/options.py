"""Option/config system compatible with the reference CLI surface.

Re-provides the `program-options-lite` contract
(`dependencies/program-options-lite`, used by
TMC3.cpp:632-1553): options come from `--name=value` command-line
arguments and from config files (`-c file` / `--config=file`) containing
`name: value` lines, processed **in order** into one flat namespace.

Attribute options are "sticky" like the reference's (TMC3.cpp:1247-1251):
per-attribute parameters (qp, bitdepth, transformType, ...) accumulate
into a pending attribute record which `attribute: <name>` commits.
"""

from __future__ import annotations

from typing import List, Tuple


class OptionError(ValueError):
    pass


def parse_config_file(path: str) -> List[Tuple[str, str]]:
    """`name: value` lines, '#' comments (reference po-lite semantics)."""
    pairs: List[Tuple[str, str]] = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if ":" not in line:
                raise OptionError(f"{path}: malformed line {raw!r}")
            name, value = line.split(":", 1)
            pairs.append((name.strip(), value.strip()))
    return pairs


def parse_argv(argv: List[str]) -> List[Tuple[str, str]]:
    """CLI args -> ordered (name, value) pairs; expands config files
    in place (so later options override, exactly like the reference)."""
    pairs: List[Tuple[str, str]] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("-c", "--config"):
            i += 1
            if i >= len(argv):
                raise OptionError(f"{arg} requires a file argument")
            pairs.extend(parse_config_file(argv[i]))
        elif arg.startswith("--config="):
            pairs.extend(parse_config_file(arg.split("=", 1)[1]))
        elif arg.startswith("--"):
            body = arg[2:]
            if "=" in body:
                name, value = body.split("=", 1)
            else:
                # allow `--flag` as `--flag=1` (po-lite bool semantics)
                name, value = body, "1"
            pairs.append((name, value))
        else:
            raise OptionError(f"unexpected argument {arg!r}")
        i += 1
    return pairs


def to_bool(v: str) -> bool:
    return v.strip().lower() not in ("0", "false", "no", "")


def to_int(v: str) -> int:
    return int(v.strip(), 0)


def to_float(v: str) -> float:
    return float(v.strip())


def float_to_rational(x: float, max_den: int = 1 << 20):
    """positionQuantizationScale is a float on the CLI but a rational in
    the SPS (reference Rational seq scale, PCCMath.h:559)."""
    from fractions import Fraction
    fr = Fraction(x).limit_denominator(max_den)
    return fr.numerator, fr.denominator
