from repro_torch.train.loop import Watchdog, train_loop
from repro_torch.train.state import init_train_state, make_train_step

__all__ = ["Watchdog", "init_train_state", "make_train_step", "train_loop"]
