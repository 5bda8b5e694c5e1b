"""Finite scores retired within the drain limit for queries due in the
window, over the window's seconds."""


def read(obs):
    return obs["scored"] / obs["seconds"]
