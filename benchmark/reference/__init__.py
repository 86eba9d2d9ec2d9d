"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
nothing of the program (``dp.py`` the pairwise DP, ``tree.py`` the guide
tree, ``msa.py`` the all-pairs stage, profiles, the merge and the check of
an emitted alignment)."""
