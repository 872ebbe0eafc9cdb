"""lstm_ctc_tpu — LSTM-CTC speech recognition framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of mobvoi/lstm_ctc:
(Bi)LSTM-CTC acoustic model training with the high-rank mixture-of-softmaxes
head, Kaldi-format data interchange, and EESEN TLG WFST decode integration.

Public API mirrors the reference's ``nnet`` package façade
(reference nnet/__init__.py:15-26).
"""

__version__ = "0.1.0"

from .config import parse_config, format_config
from .train.class_prior import get_class_prior
from .train.checkpoint import load_checkpoint, save_checkpoint
from .train.graph import get_optimizer, make_eval_step, make_train_step
from .train.loop import run_training_epoch, run_validation_epoch
from .models import apply_model, init_model
from .ops import ctc_loss
