"""The port's entry points, the counterparts of the JAX package's scripts:

    python -m remfx_tpu_torch.cli.demo_detect +exp=remfx_detect \
        +audio_input=in.wav [+target=dry.wav] [+output_path=out.wav]
    python -m remfx_tpu_torch.cli.remfx_detect +exp=remfx_detect \
        +audio_input=in.wav +output_path=out.wav
    python -m remfx_tpu_torch.cli.chain_inference +exp=remfx_detect ...
    python -m remfx_tpu_torch.cli.generate_dataset +exp=5-5
    python -m remfx_tpu_torch.cli.eval_matrix --n 0,1 --classifier DIR \
        --ckpt EFFECT_CLASS=DIR ...

They take the JAX scripts' command lines: ``+key=value``
(``config/core.py:parse_cli``), and ``eval_matrix``'s flags. They run on
the card, and on the host with ``accelerator=cpu`` (``eval_matrix``:
``--accelerator cpu``).
"""
