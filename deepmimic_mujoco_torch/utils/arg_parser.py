"""DeepMimic ``--key value ...`` arg-file parser (copy of
``deepmimic_mujoco_tpu/utils/arg_parser.py``), for the arg files of
``assets/args/`` (``--agent_files``, ``--model_files``, ...).

Format: whitespace-separated tokens; ``--name`` starts a key and the
following tokens that do not start with ``--`` are its values; ``#``
starts a comment that runs to the end of the line."""

from __future__ import annotations


class ArgParser:
    def __init__(self):
        self._table: dict[str, list[str]] = {}

    def load_args(self, arg_strs: list[str]) -> bool:
        curr_key = None
        for token in arg_strs:
            if token.startswith("--"):
                curr_key = token[2:]
                self._table.setdefault(curr_key, [])
            elif curr_key is not None:
                self._table[curr_key].append(token)
        return True

    def load_file(self, filename: str) -> bool:
        with open(filename) as f:
            tokens = []
            for line in f:
                tokens += line.split("#", 1)[0].split()
        return self.load_args(tokens)

    def has_key(self, key: str) -> bool:
        return key in self._table

    def parse_string(self, key: str, default: str = "") -> str:
        vals = self._table.get(key)
        return vals[0] if vals else default

    def parse_strings(self, key: str, default=()) -> list[str]:
        return list(self._table.get(key, default))

    def parse_int(self, key: str, default: int = 0) -> int:
        vals = self._table.get(key)
        return int(vals[0]) if vals else default

    def parse_ints(self, key: str, default=()) -> list[int]:
        return [int(v) for v in self._table.get(key, default)]

    def parse_float(self, key: str, default: float = 0.0) -> float:
        vals = self._table.get(key)
        return float(vals[0]) if vals else default

    def parse_floats(self, key: str, default=()) -> list[float]:
        return [float(v) for v in self._table.get(key, default)]

    def parse_bool(self, key: str, default: bool = False) -> bool:
        vals = self._table.get(key)
        if not vals:
            return default
        return vals[0].lower() in ("true", "1", "yes")

    def parse_bools(self, key: str, default=()) -> list[bool]:
        return [v.lower() in ("true", "1", "yes")
                for v in self._table.get(key, default)]
