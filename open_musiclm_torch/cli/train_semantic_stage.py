"""Semantic-stage training (port of scripts/train_semantic_stage.py): train_stage
with ``--stage semantic``.

    python -m open_musiclm_torch.cli.train_semantic_stage [train_stage's flags]
"""

import sys

from .train_stage import main as train_stage_main


def main(argv=None):
    return train_stage_main(["--stage", "semantic"] + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
