"""Manifest admin: filter records out of a streamed-pickle manifest.

The port of ``devt_tpu/tools/admin.py``, on the port's own
``data/manifests.py`` (``stream_pickle``, ``append_pickle``): a streamed
re-dump that drops the records a predicate rejects (the reference's
``src/data_processing/tools/admin.py:12-19`` drops one corrupt title).
Host code only: no tensor is involved.

Usage:
    python -m devt_tpu_torch.tools.admin in.pkl out.pkl --drop-path "bad/title"
"""

from __future__ import annotations

import argparse
from typing import Callable

from devt_tpu_torch.data.manifests import append_pickle, stream_pickle


def filter_manifest(in_path: str, out_path: str,
                    keep: Callable[[dict], bool]) -> tuple[int, int]:
    """Re-stream ``in_path`` into ``out_path`` keeping records where
    ``keep(record)``.  Returns (kept, dropped)."""
    kept = dropped = 0
    for rec in stream_pickle(in_path):
        if keep(rec):
            append_pickle(out_path, rec)
            kept += 1
        else:
            dropped += 1
    return kept, dropped


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--drop-path", action="append", default=[],
                        help="drop records whose path contains this string")
    args = parser.parse_args(argv)

    def keep(rec: dict) -> bool:
        path = str(rec.get("path", ""))
        return not any(bad in path for bad in args.drop_path)

    kept, dropped = filter_manifest(args.input, args.output, keep)
    print(f"kept {kept}, dropped {dropped}")


if __name__ == "__main__":
    main()
