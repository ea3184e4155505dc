"""canu_tpu_torch command line (canu.pl's argument surface, as canu_tpu's).

Usage:
  python -m canu_tpu_torch -p <prefix> -d <dir> genomeSize=4.6m \
      [-s spec.file] [key=value ...] \
      -pacbio-raw reads.fq [...] | -pacbio-corrected r.fa | -trimmed r.fa
  python -m canu_tpu_torch -options        # print the parameter registry

Argument parsing as canu.pl:143-255, mode selection as canu.pl:341-525;
nanopore inputs use -nanopore-raw etc.  The pipeline runs on the CUDA
card and fails without one.
"""

from __future__ import annotations

import sys

from .config import Config, ConfigError
from .pipeline.driver import run_pipeline


def main(argv: list[str], device=None) -> int:
    """Run the command line ``argv``; the pipeline runs on ``device`` (the
    card unless the caller asks for "cpu")."""
    cfg = Config()
    prefix = "asm"
    work_dir = "."
    raw: list[str] = []
    corrected: list[str] = []
    trimmed: list[str] = []

    i = 0
    mode: list[str] | None = None
    while i < len(argv):
        a = argv[i]
        if a == "-options":
            print(cfg.print_options())
            return 0
        if a == "-p":
            i += 1
            prefix = argv[i]
        elif a == "-d":
            i += 1
            work_dir = argv[i]
        elif a == "-s":
            i += 1
            cfg.parse_spec_file(argv[i])
        elif a in ("-pacbio-raw", "-nanopore-raw"):
            # the technology's default group applies in run_pipeline
            # (canu.pl:499-517)
            cfg.set("readType", a.split("-")[1])
            mode = raw
        elif a in ("-pacbio-corrected", "-nanopore-corrected", "-corrected"):
            if a != "-corrected":
                cfg.set("readType", a.split("-")[1])
            mode = corrected
        elif a == "-trimmed":
            mode = trimmed
        elif a.startswith("-"):
            print(f"unknown option {a}", file=sys.stderr)
            return 2
        elif "=" in a:
            cfg.parse_assign(a)
        elif mode is not None:
            mode.append(a)
        else:
            print(f"unexpected argument {a}", file=sys.stderr)
            return 2
        i += 1

    try:
        run_pipeline(work_dir, prefix, cfg, raw_reads=raw or None,
                     corrected_reads=corrected or None, trimmed_reads=trimmed or None,
                     device=device)
    except ConfigError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
