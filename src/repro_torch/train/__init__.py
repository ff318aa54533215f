from repro_torch.train.loop import Watchdog, train_loop
from repro_torch.train.state import init_train_state, make_train_step, train_state_specs

__all__ = ["Watchdog", "init_train_state", "make_train_step", "train_loop", "train_state_specs"]
