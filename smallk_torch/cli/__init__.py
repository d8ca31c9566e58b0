"""Command-line tools of the port.

`run_cli` is the process exit boundary: it maps Python exceptions onto
the reference's Result codes (common/include/nmf.hpp:17-26), which are
the reference mains' int-return contract — argument and validation
errors exit Result.BAD_PARAM, overflow/size failures
Result.SIZE_TOO_LARGE, anything else Result.FAILURE.  It is the port's
own copy of `smallk_tpu.cli.run_cli`; the reference's `--compile-cache`
flag (an XLA setting) has no counterpart here.
"""

from __future__ import annotations

import sys


def run_cli(main, argv=None) -> int:
    """Run a CLI main() and translate its outcome to a Result code."""
    from ..common.options import Result

    try:
        rc = main(argv)
        return int(Result.OK if rc in (0, None) else Result(rc))
    except SystemExit as e:  # argparse --help (0) or usage errors (2)
        if e.code in (0, None):
            return int(Result.OK)
        return int(Result.BAD_PARAM)
    except (ValueError, KeyError, FileNotFoundError, IsADirectoryError,
            PermissionError) as e:
        print(f"error: {e}", file=sys.stderr)
        return int(Result.BAD_PARAM)
    except (MemoryError, OverflowError) as e:
        print(f"error: {e}", file=sys.stderr)
        return int(Result.SIZE_TOO_LARGE)
    except KeyboardInterrupt:
        raise
    except Exception as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return int(Result.FAILURE)
