# ------------------------------------------------------------------
"""Command-line entry points of the port. Each takes every Config field
as a flag, plus ``--device`` (default cuda)."""
# ------------------------------------------------------------------

import argparse
import sys


def split_device(argv):
    """(--device or None, the other arguments) of ``argv`` (default: the
    process's arguments)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    ns, rest = pre.parse_known_args(sys.argv[1:] if argv is None else argv)
    return ns.device, rest
