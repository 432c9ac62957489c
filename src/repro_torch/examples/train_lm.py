"""Train a reduced assigned-architecture LM end to end through the port.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_lm \
      --arch recurrentgemma-2b --steps 100 --device cpu

Any of the 10 assigned architectures works (--arch whisper-small,
deepseek-v2-lite-16b, ...); the model is the reduced smoke variant by
default.  Loss decreases on the synthetic Markov-bigram corpus.  The
reference example's arguments (``--arch qwen2.5-3b --steps 60 --batch 8
--seq 128``) come first, so any flag given here overrides its own; the
device defaults to ``cuda``.  On the card, pass --full to train the exact
published config (see ``repro_torch/launch/train.py``).
"""
import sys

from repro_torch.launch.train import main as train_main

DEFAULTS = ["--arch", "qwen2.5-3b", "--steps", "60", "--batch", "8",
            "--seq", "128"]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    return train_main(DEFAULTS + argv)


if __name__ == "__main__":
    sys.exit(main())
