"""Config-file + CLI option parser (host code, the same as the JAX
package's utils/options.py).

The analog of the reference's df::program_options_lite (reference:
source/Lib/Utilities/program_options_lite.{cpp,h} — declarative option
table binding names to values with defaults and help; `-c file.cfg`
includes with `Key : Value` lines and '#' comments; later sources override
earlier ones; EncAppCfg.cpp:791+ builds the table, README.md:33-58 shows
the layered base-cfg + per-sequence-cfg + CLI-override usage).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class Option:
    name: str
    default: Any
    help: str = ""
    parse: Callable[[str], Any] | None = None

    def convert(self, text: str) -> Any:
        if self.parse is not None:
            return self.parse(text)
        if isinstance(self.default, bool):
            return text.strip().lower() in ("1", "true", "yes", "on")
        if isinstance(self.default, int):
            return int(text, 0)
        if isinstance(self.default, float):
            return float(text)
        if isinstance(self.default, list):
            return self.default + [text]     # repeatable option
        return text


class OptionParser:
    """Layered option parsing: defaults <- cfg files (in order) <- CLI."""

    def __init__(self) -> None:
        self._opts: dict[str, Option] = {}

    def add(self, name: str, default: Any, help_text: str = "",
            parse: Callable[[str], Any] | None = None) -> None:
        self._opts[name.lower()] = Option(name, default, help_text, parse)

    def _opt(self, name: str) -> Option:
        key = name.strip().lower()
        if key not in self._opts:
            raise SystemExit(f"unknown option '{name}' (see --help)")
        return self._opts[key]

    def parse_cfg_file(self, path: str, values: dict[str, Any]) -> None:
        """`Key : Value` lines; '#' comments (reference cfg format)."""
        with open(path) as f:
            for raw in f:
                line = raw.split("#", 1)[0].strip()
                if not line:
                    continue
                if ":" not in line:
                    raise ValueError(f"{path}: bad cfg line: {raw.rstrip()}")
                key, val = line.split(":", 1)
                opt = self._opt(key)
                cur = values.get(opt.name, opt.default)
                if isinstance(cur, list):
                    values[opt.name] = cur + [opt.convert(val.strip())[-1]] \
                        if opt.parse is None else cur + [opt.parse(val.strip())]
                else:
                    values[opt.name] = opt.convert(val.strip())

    def parse(self, argv: list[str]) -> dict[str, Any]:
        values = {o.name: (list(o.default) if isinstance(o.default, list)
                           else o.default) for o in self._opts.values()}
        i = 0
        while i < len(argv):
            arg = argv[i]
            if arg in ("-c", "--config"):
                self.parse_cfg_file(argv[i + 1], values)
                i += 2
                continue
            if arg in ("-h", "--help"):
                raise SystemExit(self.help_text())
            if arg.startswith("--"):
                body = arg[2:]
                if "=" in body:
                    key, val = body.split("=", 1)
                else:
                    key, val = body, "1"     # bare flag -> true
                opt = self._opt(key)
                cur = values[opt.name]
                if isinstance(cur, list):
                    values[opt.name] = cur + [opt.parse(val) if opt.parse
                                              else val]
                else:
                    values[opt.name] = opt.convert(val)
                i += 1
                continue
            # short options: -b file, -i file, -o file, -q qp, -f frames
            shorts = {"-b": "BitstreamFile", "-i": "InputFile",
                      "-o": "ReconFile", "-q": "QP",
                      "-f": "FramesToBeEncoded", "-wdt": "SourceWidth",
                      "-hgt": "SourceHeight"}
            if arg in shorts:
                opt = self._opt(shorts[arg])
                values[opt.name] = opt.convert(argv[i + 1])
                i += 2
                continue
            raise SystemExit(f"unknown argument '{arg}'\n{self.help_text()}")
        return values

    def help_text(self) -> str:
        lines = ["options:"]
        for o in self._opts.values():
            lines.append(f"  --{o.name:<28} [{o.default!r}] {o.help}")
        return "\n".join(lines)


def parse_epipole(text: str) -> tuple[int, int, float, float, float]:
    """--Epipole=curPOC,refPOC,x,y,z (reference: EncAppCfg.cpp:3278
    parseEpipole)."""
    parts = text.split(",")
    if len(parts) != 5:
        raise ValueError(f"--Epipole expects 5 comma values, got '{text}'")
    return (int(parts[0]), int(parts[1]), float(parts[2]), float(parts[3]),
            float(parts[4]))
