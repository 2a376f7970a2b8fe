"""The program's entries that a traffic mix's window drives, one module an
entry, found by the mix's ``entry`` as ``entries/<entry>.py``
(``gpubench.cells``)."""
