"""The demos' shared `--device` argument."""
from __future__ import annotations

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument('--device', default=None, choices=('cuda', 'cpu'),
                    help="'cuda' (default; raises without a card) or 'cpu' "
                         '(the plain versions of the kernels)')
    return ap
