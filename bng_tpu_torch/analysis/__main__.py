"""`python -m bng_tpu_torch.analysis` — alias for `python -m bng_tpu_torch check`."""

import sys

# guarded (the reference's module is not): walking the package imports
# every module, and this one must not run the analyzer when imported
if __name__ == "__main__":
    from bng_tpu_torch.analysis.cli import main

    sys.exit(main())
