"""Systems under test, one module a kind, found by the ``system`` of a
configuration.  Each builds the program from the configuration and
drives one of its entries; nothing else of the program is used."""
