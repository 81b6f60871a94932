"""The port's entry points, the counterparts of the JAX package's scripts:

    python -m remfx_tpu_torch.cli.demo_detect +exp=remfx_detect \
        +audio_input=in.wav [+target=dry.wav] [+output_path=out.wav]
    python -m remfx_tpu_torch.cli.remfx_detect +exp=remfx_detect \
        +audio_input=in.wav +output_path=out.wav
    python -m remfx_tpu_torch.cli.chain_inference +exp=remfx_detect ...

They take the JAX scripts' ``+key=value`` command line
(``config/core.py:parse_cli``), run on the card, and run on the host with
``accelerator=cpu``.
"""
