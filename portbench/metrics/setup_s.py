"""Seconds from the process's start to the window's opening: loading
(and, in a fresh checkout, building) the program, making the inputs,
building the table, warming the window's keys."""


def read(rec):
    return rec.get("setup_s")
