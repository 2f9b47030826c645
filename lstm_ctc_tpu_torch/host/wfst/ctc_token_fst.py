"""CTC token FST (T) topology — blank self-loops + label collapse.

The port's copy of ``lstm_ctc_tpu/wfst/ctc_token_fst.py``.

Behavior mirror of reference local/ctc_token_fst.py:27-47: from a
tokens.txt symbol table produce the text-format transducer that maps
framewise CTC token sequences (with <blk> and repeats) to collapsed label
sequences:

  state 0: start/final; eps → state 1
  state 1: <blk> self-loop (leading/size-consuming blanks)
  state 2: <blk> self-loop then eps back to 0 (trailing blanks)
  one state per unit: entered from 1 emitting the unit, self-loop
  consuming repeats silently, eps exit to 2
  disambiguation symbols (#k) pass through on state 0.
"""

from __future__ import annotations

from typing import Iterable, List


def ctc_token_fst_text(token_lines: Iterable[str]) -> str:
    out: List[str] = [
        "0 1 <eps> <eps>",
        "1 1 <blk> <eps>",
        "2 2 <blk> <eps>",
        "2 0 <eps> <eps>",
    ]
    node = 3
    for line in token_lines:
        fields = line.strip().split()
        if not fields:
            continue
        phone = fields[0]
        if phone in ("<eps>", "<blk>"):
            continue
        if "#" in phone:
            out.append("0 0 <eps> %s" % phone)
        else:
            out.append("1 %d %s %s" % (node, phone, phone))
            out.append("%d %d %s <eps>" % (node, node, phone))
            out.append("%d 2 <eps> <eps>" % node)
            node += 1
    out.append("0")
    return "\n".join(out) + "\n"
