"""Trip-count-aware collective accounting over compiled HLO text: the
port's copy of ``repro.perf.hlo_scale``, a text parser that needs no
backend.

Compiled HLO prints each ``while`` body once; collectives inside scanned
layers would be undercounted by the trip count.  This parser splits the
module into computations, finds ``while`` ops with their condition/body
computations, extracts the loop bound from the condition's integer
constants, and recursively scales collective bytes by the trip counts.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from .roofline import _COLLECTIVES, collective_bytes

_COMP_START = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(")
_WHILE_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_WHILE_BODY_RE = re.compile(r"body=%?([\w.\-]+)")
_CONST_RE = re.compile(r"=\s*[su]\d+\[\]\s*constant\((\d+)\)")


def split_computations(hlo: str) -> Dict[str, Tuple[str, bool]]:
    """-> {name: (body_text, is_entry)}.

    Computation headers sit at column 0 (ops are indented); a computation
    ends at the column-0 ``}``.  Headers may wrap across lines — everything
    until the closing ``}`` is simply attributed to the computation.
    """
    comps: Dict[str, Tuple[str, bool]] = {}
    lines = hlo.splitlines()
    name, entry, body = None, False, []
    for line in lines:
        if name is None:
            m = _COMP_START.match(line)
            if m:
                name = m.group(2)
                entry = bool(m.group(1))
                body = [line]
        else:
            body.append(line)
            if line.startswith("}"):
                comps[name] = ("\n".join(body), entry)
                name, body = None, []
    if name is not None:
        comps[name] = ("\n".join(body), entry)
    return comps


def _trip_count(cond_text: str) -> int:
    consts = [int(c) for c in _CONST_RE.findall(cond_text)]
    return max(consts) if consts else 1


def scaled_collective_bytes(hlo: str) -> Dict[str, int]:
    """Collective operand bytes with while-loops scaled by trip count."""
    comps = split_computations(hlo)
    memo: Dict[str, Dict[str, int]] = {}

    def total(name: str) -> Dict[str, int]:
        if name in memo:
            return memo[name]
        memo[name] = {k: 0 for k in _COLLECTIVES}   # cycle guard
        text, _ = comps.get(name, ("", False))
        acc = collective_bytes(text)
        for line in text.splitlines():
            if " while(" not in line:
                continue
            cm = _WHILE_COND_RE.search(line)
            bm = _WHILE_BODY_RE.search(line)
            if not (cm and bm):
                continue
            trips = _trip_count(comps.get(cm.group(1), ("", False))[0])
            sub = total(bm.group(1))
            for k in _COLLECTIVES:
                acc[k] += trips * sub[k]
        memo[name] = acc
        return acc

    entries = [n for n, (_, e) in comps.items() if e]
    if not entries:
        return collective_bytes(hlo)
    out = {k: 0 for k in _COLLECTIVES}
    for e in entries:
        sub = total(e)
        for k in _COLLECTIVES:
            out[k] += sub[k]
    return out
