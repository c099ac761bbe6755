#!/usr/bin/env python3
"""Supervised profile-classifier CLI of the PyTorch port, with the flags
of ``scripts/train_profile.py`` plus ``--device`` (default: the card;
without one it raises unless ``--device cpu`` is given):

    python scripts/train_profile_torch.py -d DATASET_DIR -m MODELCARD.yaml

Logs and checkpoints (top-k by ``valid_acc``) go to
``<logdir>/<card>_<dataset>/version_k/``; the best checkpoint is
tested at the end. A ``.json`` card needs no PyYAML.

Under ``torchrun --nproc_per_node N`` each process trains on its card's
share of every batch (the card's ``mesh: {data: N}``, or none); rank 0
writes the run directory.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multimodal_plankton_recognition_torch.parallel import (  # noqa: E402
    multihost,
)
from multimodal_plankton_recognition_torch.train.drivers import (  # noqa: E402
    train_profile,
)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-d", "--dataset",
                        help="Location to dataset tables.", required=True)
    parser.add_argument("-m", "--modelcard", required=True,
                        help="Path to model card (yaml or json file).")
    parser.add_argument("-l", "--logdir", default="logs")
    parser.add_argument("--resume", default=None,
                        help="Port checkpoint dir to resume from (its latest "
                             "step: masters, statistics, optimizer state, "
                             "step).")
    parser.add_argument("--profile", action="store_true",
                        help="Write a torch.profiler trace of the first "
                             "epoch into the run's logdir.")
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="Device to train on (default: the card).")
    args = parser.parse_args(argv)

    multihost.initialize(device=args.device)
    try:
        result = train_profile(args.dataset, args.modelcard, args.logdir,
                               max_epochs=args.max_epochs, resume=args.resume,
                               profile=args.profile, device=args.device)
        print(f"Test accuracy: {result['test_acc']:.4f}; "
              f"logs in {result['logdir']}")
    finally:
        multihost.shutdown()
    return result


if __name__ == "__main__":
    main()
