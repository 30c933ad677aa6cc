"""LM model stack of the port: the decoder families (``transformer``, with
``moe`` and MLA in ``attention``), Mamba2 (``ssm``, ``mamba_lm``), the
hybrid (``zamba``), the encoder-decoder (``whisper``), their layers, the
family registry and the weight converter."""
