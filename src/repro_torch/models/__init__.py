"""The LM zoo (reference ``repro.models``): ``layers``, ``attention``,
``moe``, ``mamba2`` and ``transformer`` for the ``dense``, ``moe``,
``ssm`` and ``hybrid`` families."""
