"""Host seconds of building the program's basis and its solver (the
constructor of the entry point), up to a synchronisation of the card."""


def read(run):
    return run.tables_s
