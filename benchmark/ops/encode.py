"""The encode chunk step of `carta1_tpu_torch.processor`, on one card:
`_encode_batch_dev(frames, options, state, engine=...)`, int16 frames
[rows, F, 512] -> 212-byte units [rows, F, 212], with the configuration's
options and engine.  The calls read the traffic's PCM."""

from benchmark import program

FAMILY = "encode"


def inputs(config: dict, pcm, devices):
    return pcm


def step(config: dict, devices):
    from carta1_tpu_torch import processor

    opts, engine = program.options(config), config["engine"]
    return lambda chunk, state: processor._encode_batch_dev(chunk, opts, state, engine=engine)
