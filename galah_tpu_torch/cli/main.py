"""Top-level CLI of the port: cluster / cluster-validate / analyse /
process (counterpart of galah_tpu/cli/main.py, without its TPU-only
compile-cache and jax.config lines).

A subcommand resolves the device (utils/device.py) only when it builds
a native engine, so analyse and the finch/skani/fastANI methods never
touch the card."""

from __future__ import annotations

import argparse
import os
import sys

from galah_tpu_torch import __version__


def build_parser() -> argparse.ArgumentParser:
    from galah_tpu_torch.cli.analyse_cmd import add_analyse_arguments
    from galah_tpu_torch.cli.cluster_cmd import add_cluster_arguments
    from galah_tpu_torch.cli.process_cmd import add_process_arguments
    from galah_tpu_torch.cli.validate_cmd import add_validate_arguments

    parser = argparse.ArgumentParser(
        prog="galah-tpu-torch",
        description="galah_tpu_torch: metagenome assembled genome (MAG) "
        "dereplicator / clusterer on PyTorch and CUDA",
    )
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="subcommand", metavar="SUBCOMMAND")
    cluster_p = sub.add_parser("cluster", help="Cluster (dereplicate) genomes")
    add_cluster_arguments(cluster_p)
    validate_p = sub.add_parser("cluster-validate",
                                help="Verify clustering results")
    add_validate_arguments(validate_p)
    analyse_p = sub.add_parser(
        "analyse", help="Analyse rRNAs/tRNAs of FASTA files for MIMAG status")
    add_analyse_arguments(analyse_p)
    process_p = sub.add_parser("process",
                               help="Analyse and cluster genomes in one run")
    add_process_arguments(process_p)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.subcommand is None:
        parser.print_help()
        return 2
    try:
        if args.subcommand == "cluster":
            from galah_tpu_torch.cli.cluster_cmd import run_cluster

            run_cluster(args)
        elif args.subcommand == "cluster-validate":
            from galah_tpu_torch.cli.validate_cmd import run_validate

            run_validate(args)
        elif args.subcommand == "analyse":
            from galah_tpu_torch.cli.analyse_cmd import run_analyse

            run_analyse(args)
        else:
            from galah_tpu_torch.cli.process_cmd import run_process

            run_process(args)
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
