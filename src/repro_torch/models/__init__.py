"""The LM zoo (reference ``repro.models``): ``layers``, ``attention``,
``mamba2`` and ``transformer`` for the ``dense``, ``ssm`` and ``hybrid``
families."""
