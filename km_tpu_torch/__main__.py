"""``python -m km_tpu_torch`` entry point."""

from .cli import main

main()
