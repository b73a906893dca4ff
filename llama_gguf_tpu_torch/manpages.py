"""Man pages from the argparse tree (port of llama_gguf_tpu/manpages.py):
troff man(1) pages for the top-level command and every subcommand.
"""

from __future__ import annotations

import argparse
import os
import time


def _troff_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace("-", "\\-")


def _render_page(prog: str, parser: argparse.ArgumentParser) -> str:
    date = time.strftime("%Y-%m-%d")
    name = prog.replace(" ", "-")
    lines = [
        f'.TH "{name.upper()}" "1" "{date}" "llama-gguf-tpu" "User Commands"',
        ".SH NAME",
        f"{_troff_escape(name)} \\- {_troff_escape(parser.description or '')}",
        ".SH SYNOPSIS",
        f".B {_troff_escape(prog)}",
    ]
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            lines.append("\\fICOMMAND\\fR [\\fIARGS\\fR...]")
        elif action.option_strings:
            opt = action.option_strings[-1]
            lines.append(f"[\\fB{_troff_escape(opt)}\\fR]")
        elif action.dest != "help":
            lines.append(f"\\fI{_troff_escape(action.dest.upper())}\\fR")
    lines.append(".SH OPTIONS")
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            continue
        if action.option_strings:
            opts = ", ".join(_troff_escape(o) for o in action.option_strings)
            lines += [".TP", f"\\fB{opts}\\fR",
                      _troff_escape(action.help or "")]
        elif action.dest != "help":
            lines += [".TP", f"\\fI{_troff_escape(action.dest)}\\fR",
                      _troff_escape(action.help or "")]
    subs = [a for a in parser._actions
            if isinstance(a, argparse._SubParsersAction)]
    if subs:
        lines.append(".SH COMMANDS")
        for sub in subs:
            for cname, cparser in sub.choices.items():
                lines += [".TP", f"\\fB{_troff_escape(cname)}\\fR",
                          _troff_escape(cparser.description
                                        or (cparser.format_usage().strip()))]
    lines += [
        ".SH ENVIRONMENT",
        ".TP", "\\fBLLAMA_GGUF_<SECTION>_<KEY>\\fR",
        "Override any config value, e.g. LLAMA_GGUF_SERVER_PORT=9000.",
        ".SH SEE ALSO",
        "llama\\-gguf\\-tpu(1)",
    ]
    return "\n".join(lines) + "\n"


def write_manpages(parser: argparse.ArgumentParser, out_dir: str) -> int:
    man1 = os.path.join(out_dir, "man1")
    os.makedirs(man1, exist_ok=True)
    prog = parser.prog
    count = 0
    with open(os.path.join(man1, f"{prog}.1"), "w") as f:
        f.write(_render_page(prog, parser))
    count += 1
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for cname, cparser in action.choices.items():
                page = _render_page(f"{prog} {cname}", cparser)
                with open(os.path.join(man1, f"{prog}-{cname}.1"), "w") as f:
                    f.write(page)
                count += 1
    return count
