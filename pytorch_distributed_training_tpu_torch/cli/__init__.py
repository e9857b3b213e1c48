"""The ``--serve`` command line of the port."""
