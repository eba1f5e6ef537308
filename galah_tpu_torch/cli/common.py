"""Shared CLI plumbing: genome-spec arguments, percentage parsing,
logging flags.

Replaces the reference's bird_tool_utils helpers: the genome input
arguments -f/--genome-fasta-files, -d/--genome-fasta-directory,
-x/--genome-fasta-extension, --genome-fasta-list
(src/cluster_argument_parsing.rs:1753-1754) and `parse_percentage`
(src/cluster_argument_parsing.rs:1491-1512).

The port's own copy of galah_tpu/cli/common.py, so that the port imports
nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional


class _FullHelpAction(argparse.Action):
    """--full-help: the complete option listing (the reference renders a
    man page via bird_tool_utils-man; here the argparse help is already
    the full reference)."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.print_help()
        parser.exit(0)


class _FullHelpRoffAction(argparse.Action):
    """--full-help-roff: emit the help as a roff man page for pandoc
    conversion, like the reference's --full-help-roff
    (src/cluster_argument_parsing.rs:1532-1601, admin/build_docs.py)."""

    def __call__(self, parser, namespace, values, option_string=None):
        print(format_roff(parser))
        parser.exit(0)


def format_roff(parser: argparse.ArgumentParser) -> str:
    from galah_tpu_torch import __version__

    name = parser.prog.replace(" ", "-")
    lines = [
        f'.TH "{name}" "1" "" "galah-tpu {__version__}" "User Commands"',
        ".SH NAME",
        f"{name} \\- {parser.description or ''}",
        ".SH OPTIONS",
    ]
    for action in parser._actions:
        if not action.option_strings:
            continue
        opts = ", ".join(action.option_strings)
        metavar = action.metavar or (
            action.dest.upper() if action.nargs != 0 else ""
        )
        head = f"{opts} {metavar}".strip()
        lines.append(".TP")
        lines.append(f"\\fB{head}\\fR")
        lines.append((action.help or "").replace("\\", "\\\\"))
    return "\n".join(lines)


def add_full_help_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--full-help", nargs=0, action=_FullHelpAction,
                        help="Display the complete option help")
    parser.add_argument("--full-help-roff", nargs=0, action=_FullHelpRoffAction,
                        help="Output the complete help as a roff man page")


def add_verbosity_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "-v", "--verbose", action="store_true", help="Print extra debugging information"
    )
    parser.add_argument(
        "-q", "--quiet", action="store_true", help="Unless there is an error, do not print log messages"
    )


def set_log_level(args: argparse.Namespace) -> None:
    level = logging.INFO
    if getattr(args, "verbose", False):
        level = logging.DEBUG
    elif getattr(args, "quiet", False):
        level = logging.ERROR
    logging.basicConfig(
        level=level,
        format="[%(asctime)s] %(levelname)s: %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
        stream=sys.stderr,
        force=True,
    )


def add_genome_specification_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "-f",
        "--genome-fasta-files",
        nargs="+",
        metavar="PATH",
        help="Path(s) to FASTA files of each genome",
    )
    parser.add_argument(
        "-d",
        "--genome-fasta-directory",
        metavar="PATH",
        help="Directory containing FASTA files of each genome",
    )
    parser.add_argument(
        "-x",
        "--genome-fasta-extension",
        metavar="EXT",
        default="fna",
        help="File extension of genomes in the directory specified with -d/--genome-fasta-directory [default: fna]",
    )
    parser.add_argument(
        "--genome-fasta-list",
        metavar="PATH",
        help="File containing FASTA file paths, one per line",
    )


def parse_list_of_genome_fasta_files(args: argparse.Namespace) -> List[str]:
    """Resolve the genome input specification to a path list. Paths from
    list files and -f have any trailing tab-separated columns stripped
    (src/cluster_argument_parsing.rs:563-567)."""
    sources = [
        bool(args.genome_fasta_files),
        bool(args.genome_fasta_directory),
        bool(args.genome_fasta_list),
    ]
    if sum(sources) == 0:
        raise SystemExit(
            "Error: One of -f/--genome-fasta-files, -d/--genome-fasta-directory "
            "or --genome-fasta-list must be specified"
        )
    if sum(sources) > 1:
        raise SystemExit(
            "Error: Only one genome input source may be specified at a time"
        )

    if args.genome_fasta_files:
        return [p.split("\t")[0] for p in args.genome_fasta_files]
    if args.genome_fasta_list:
        with open(args.genome_fasta_list) as f:
            return [
                line.rstrip("\n").split("\t")[0]
                for line in f
                if line.strip()
            ]
    d = args.genome_fasta_directory
    ext = args.genome_fasta_extension.lstrip(".")
    paths = sorted(
        os.path.join(d, name)
        for name in os.listdir(d)
        if name.endswith("." + ext)
    )
    if not paths:
        raise SystemExit(
            f"Error: No genome FASTA files with extension .{ext} found in {d}"
        )
    return paths


def parse_percentage(value: Optional[float], parameter: str) -> Optional[float]:
    """Percentage-or-fraction to fraction: values in [1, 100] are
    divided by 100, values in [0, 1) pass through, anything else errors
    (src/cluster_argument_parsing.rs:1491-1512)."""
    if value is None:
        return None
    pct = float(value)
    if 1.0 <= pct <= 100.0:
        pct /= 100.0
    elif not (0.0 <= pct <= 100.0):
        raise SystemExit(
            f"Invalid percentage specified for --{parameter}: '{value}'"
        )
    return pct
