from repro_torch.train.steps import (  # noqa: F401
    cross_entropy_loss,
    make_train_step,
    make_prefill_step,
    make_decode_step,
    greedy_generate,
    TrainState,
)
