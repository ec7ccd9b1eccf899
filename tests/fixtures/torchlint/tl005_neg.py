"""TL005 negative fixture: the rebind-from-result pattern, a step that
does not donate, and adamw_update without in_place."""
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.train.train_loop import make_train_step

consume = make_train_step(lambda p, b: p["w"].sum(), AdamWConfig())


def good(params, opt, batch):
    params, opt, metrics = consume(params, opt, batch)   # rebound
    return params, opt, metrics


def also_good(params, opt, batch):
    step = make_train_step(lambda p, b: p["w"].sum(), AdamWConfig(),
                           donate=False)
    out = step(params, opt, batch)
    return params, out           # donate=False: params is untouched


def fresh(grads, state, params, cfg):
    new_params, new_state, m = adamw_update(grads, state, params, cfg)
    return params, state, new_params, new_state, m
