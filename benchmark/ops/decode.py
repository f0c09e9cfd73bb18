"""The decode chunk step of `carta1_tpu_torch.processor`, on one card:
`_decode_batch_dev(units, state, to_i16=True)`, units [rows, F, 212] ->
int16 PCM [rows, F, 512].  The calls read the units of the traffic's
tracks, made at set-up by the configuration's engine
(`program.encode_track`)."""

from benchmark import program

FAMILY = "decode"


def inputs(config: dict, pcm, devices):
    return program.encode_track(config, pcm)


def step(config: dict, devices):
    from carta1_tpu_torch import processor

    return lambda chunk, state: processor._decode_batch_dev(chunk, state, to_i16=True)
