"""One driver a traffic kind: it sets up the program for a cell, drives its
units of work, reports the end-to-end metrics and checks the window's
answers against the reference (``walk``, ``fit``, ``matrix``)."""
