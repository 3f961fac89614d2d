"""setup_s: seconds from the process's start to the window's start."""


def read(record):
    return record['setup_s']
