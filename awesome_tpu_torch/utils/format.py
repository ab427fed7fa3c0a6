"""String formatting helpers; counterpart of ``awesome_tpu/utils/format.py``
(spec: `awesome/util/format.py`, `awesome/util/path_tools.py` numerated
filenames)."""
from __future__ import annotations

import os
import re
from datetime import timedelta


def strfdelta(delta: timedelta, fmt: str = "{H:02}:{M:02}:{S:02}") -> str:
    """Format a timedelta: placeholders D, H, M, S."""
    if isinstance(delta, (int, float)):
        delta = timedelta(seconds=delta)
    total = int(delta.total_seconds())
    d, rem = divmod(total, 86400)
    h, rem = divmod(rem, 3600)
    m, s = divmod(rem, 60)
    if "{D" not in fmt:
        h += d * 24
        d = 0
    return fmt.format(D=d, H=h, M=m, S=s)


def snake_case(name: str) -> str:
    s = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s).lower()


def numerated_file_name(path: str) -> str:
    """First non-existing 'name_{n}.ext' variant of ``path``."""
    if not os.path.exists(path):
        return path
    base, ext = os.path.splitext(path)
    n = 1
    while os.path.exists(f"{base}_{n}{ext}"):
        n += 1
    return f"{base}_{n}{ext}"


def latex_postprocessor(text: str,
                        escape_underscores: bool = True,
                        fix_bold: bool = True,
                        fix_underline: bool = True,
                        plain_rules: bool = True) -> str:
    """Repair the LaTeX pandas emits for styled metric tables so it
    compiles standalone (spec: `awesome/util/format.py:194-232`; used by
    the evaluation notebooks on ``ResultComparison.to_latex`` output).

    - escape bare ``_`` between word characters (pandas leaves them raw),
    - rewrite the styler's ``\\bfseries tok`` / ``\\text-decorationunderline
      tok`` prefixes into proper ``\\textbf{tok}`` / ``\\underline{tok}``,
    - downgrade booktabs rules to ``\\hline`` for booktabs-free preambles.
    """
    if escape_underscores:
        text = re.sub(r"(?<=[\w])_(?=[\w])", r"\\_", text)
    # token = the styled cell value; ends at whitespace, '&', '\' (row
    # terminator '\\') or end-of-string — pandas pads a trailing space
    # mid-row but not before a row terminator
    token = r"(?P<tok>[A-Za-z0-9.\\_+-]*[A-Za-z0-9.+-]) ?(?=[\s&\\]|$)"
    if fix_bold:
        text = re.sub(r"\\bfseries %s" % token, r"\\textbf{\g<tok>}", text)
    if fix_underline:
        text = re.sub(r"\\text-decorationunderline %s" % token,
                      r"\\underline{\g<tok>}", text)
    if plain_rules:
        for rule in ("toprule", "midrule", "bottomrule"):
            text = text.replace("\\" + rule, "\\hline")
    return text
