"""``adamw_ms``: one clipped AdamW update of the cell's whole parameter
tree, as the launcher's step takes it (``optim.optimizers.global_norm``,
the optimizer's ``update`` with that norm, ``apply_updates``); median of
CUDA-event times. The gradients are AdamW's first moment, a tree of the
step's shapes that is already resident (the update's time does not
depend on the values); the results are dropped, so the program's state
is not changed."""


def read(run):
    from repro_torch.optim.optimizers import apply_updates, global_norm

    grads = run.opt_state.mu

    def call():
        norm = global_norm(grads)
        ups, _ = run.opt.update(grads, run.opt_state, run.params, grad_norm=norm)
        apply_updates(run.params, ups)

    return run.cuda_ms(call, reps=5, warmup=1)
