"""`python -m garlic_tpu` / `garlic-tpu` console entry point."""

from __future__ import annotations

import sys


def main() -> None:
    from .pipeline import run_main
    rc = run_main(sys.argv[1:], prog=sys.argv[0])
    sys.exit(rc & 0xFF)  # -1 -> 255, exactly like sys.exit(-1)


if __name__ == "__main__":
    main()
