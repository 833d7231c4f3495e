"""CPU tests of the benchmark (``python -m pytest benchmark/tests``); the
tests marked ``gpu`` run on the card only."""
