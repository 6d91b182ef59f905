"""`python -m bng_tpu_torch ...`: the port's command line (`cli.main`)."""

import sys

# a spawned slow-path worker re-imports this module as __mp_main__: the
# command line (and torch with it) is imported only when it runs
if __name__ == "__main__":
    from bng_tpu_torch.cli import main

    sys.exit(main())
