"""The LM zoo (reference ``repro.models``): ``layers``, ``attention`` and
``transformer`` for the ``dense`` family."""
