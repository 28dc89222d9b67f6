"""What the profiling examples share: the ``--device`` flag."""

from __future__ import annotations

import argparse

from ..._device import resolve_device


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p


def device(args):
    return resolve_device(args.device)
