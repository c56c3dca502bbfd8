"""Three-letter to one-letter residue map used by the CA readers.

Parity: reference merizo_search/programs/Foldclass/constants.py:1-10.
"""

THREE_TO_ONE = {
    "ALA": "A", "CYS": "C", "ASP": "D", "GLU": "E", "PHE": "F",
    "GLY": "G", "HIS": "H", "ILE": "I", "LYS": "K", "LEU": "L",
    "MET": "M", "ASN": "N", "PRO": "P", "GLN": "Q", "ARG": "R",
    "SER": "S", "THR": "T", "VAL": "V", "TRP": "W", "TYR": "Y",
    "UNK": "X", "ASH": "D", "GLH": "E", "HID": "H", "HIE": "H",
    "HIP": "H", "HSD": "H", "HSE": "H", "LYN": "K",
}
