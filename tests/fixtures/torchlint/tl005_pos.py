"""TL005 positive fixture: reading a tensor after a call updated it in
place."""
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import make_train_step

# donate defaults to True: every call of the step overwrites its
# params and opt_state arguments with the updated values (and returns
# the same tensors)
consume = make_train_step(lambda p, b: p["w"].sum(), AdamWConfig())


def bad(params, opt, batch):
    out = consume(params, opt, batch)
    return params, out           # TL005: params holds the updated values
