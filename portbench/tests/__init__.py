"""CPU tests of the benchmark; the ``gpu``-marked ones run on the card."""
