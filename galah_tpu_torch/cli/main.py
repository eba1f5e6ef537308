"""Top-level CLI of the port: the `cluster` subcommand
(counterpart of galah_tpu/cli/main.py)."""

from __future__ import annotations

import argparse
import os
import sys

from galah_tpu_torch import __version__


def build_parser() -> argparse.ArgumentParser:
    from galah_tpu_torch.cli.cluster_cmd import add_cluster_arguments

    parser = argparse.ArgumentParser(
        prog="galah-tpu-torch",
        description="galah_tpu_torch: metagenome assembled genome (MAG) "
        "dereplicator / clusterer on PyTorch and CUDA",
    )
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="subcommand", metavar="SUBCOMMAND")
    cluster_p = sub.add_parser("cluster", help="Cluster (dereplicate) genomes")
    add_cluster_arguments(cluster_p)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.subcommand is None:
        parser.print_help()
        return 2
    try:
        from galah_tpu_torch.cli.cluster_cmd import run_cluster
        from galah_tpu_torch.utils.device import resolve_device

        run_cluster(args, resolve_device())
    except (OSError, KeyError, ValueError, RuntimeError) as e:
        # One-line errors for user-facing failures; full traceback with
        # GALAH_TPU_DEBUG=1.
        if os.environ.get("GALAH_TPU_DEBUG"):
            raise
        msg = str(e.args[0] if e.args else e)
        if msg.startswith("Error: "):
            msg = msg[len("Error: "):]
        print(f"Error: {msg}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
