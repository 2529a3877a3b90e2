#!/usr/bin/env python3
"""CLI entry point: ``python main.py -t {reference,dumpref,align,dumpalign} ...``

Same task/flag surface as the reference (reference main.py); engine is the
JAX shotgun_tpu package.
"""

from shotgun_tpu.cli import main

if __name__ == "__main__":
    main()
