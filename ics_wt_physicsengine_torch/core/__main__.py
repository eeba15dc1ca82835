"""Run the eleven physics validation suites (five core, six extension
axes):

    python -m ics_wt_physicsengine_torch.core [--device cpu]

They run on the CUDA card unless ``--device`` names another device.
"""

import argparse

from ics_wt_physicsengine_torch.core import run_all_validations


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    run_all_validations(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
