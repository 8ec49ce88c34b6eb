"""Test suite. A regular package, so that an installed package named
``tests`` cannot shadow ``tests.oracle`` and the shared helpers."""
