"""Model encryption (AES-GCM): the reference's crypto IO.

Counterpart of ``paddle_tpu/framework/crypto.py``, after the reference's
``framework/io/crypto/`` (``Cipher::Encrypt / Decrypt / EncryptToFile /
DecryptFromFile``, ``CipherUtils::GenKey / GenKeyToFile``), which ships
encrypted inference models.  It runs over the optional ``cryptography``
package (``AESGCM``, a random 12-byte nonce before the ciphertext), which
is imported only when a cipher is used: key generation needs nothing.
"""

from __future__ import annotations

import os

__all__ = ["Cipher", "CipherFactory", "CipherUtils", "is_available"]


def is_available() -> bool:
    """True when the optional ``cryptography`` package is importable.
    Key generation works without it; encrypt/decrypt do not."""
    try:
        import cryptography  # noqa: F401

        return True
    except ImportError:
        return False


def _aesgcm_cls():
    """``AESGCM``, imported when a cipher is used, with an error that says
    what to install: importing this module needs no ``cryptography``."""
    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    except ImportError as e:
        raise ImportError(
            "paddle_tpu_torch.framework.crypto needs the optional 'cryptography' "
            "package for AES-GCM encrypt/decrypt; install it with "
            "`pip install cryptography` (key generation alone does not "
            "require it)") from e
    return AESGCM


class Cipher:
    """AES-GCM cipher (reference default: AES-256-GCM)."""

    _NONCE = 12

    def _aes(self, key: bytes):
        AESGCM = _aesgcm_cls()

        if len(key) not in (16, 24, 32):
            raise ValueError(
                f"AES key must be 16/24/32 bytes, got {len(key)}")
        return AESGCM(key)

    def encrypt(self, plaintext: bytes, key: bytes) -> bytes:
        nonce = os.urandom(self._NONCE)
        return nonce + self._aes(key).encrypt(nonce, bytes(plaintext), None)

    def decrypt(self, ciphertext: bytes, key: bytes) -> bytes:
        nonce, body = ciphertext[:self._NONCE], ciphertext[self._NONCE:]
        return self._aes(key).decrypt(nonce, body, None)

    def encrypt_to_file(self, plaintext: bytes, key: bytes, filename: str):
        with open(filename, "wb") as f:
            f.write(self.encrypt(plaintext, key))

    def decrypt_from_file(self, key: bytes, filename: str) -> bytes:
        with open(filename, "rb") as f:
            return self.decrypt(f.read(), key)

    # reference C++ casing
    Encrypt = encrypt
    Decrypt = decrypt
    EncryptToFile = encrypt_to_file
    DecryptFromFile = decrypt_from_file


class CipherFactory:
    @staticmethod
    def create_cipher(config_fname: str = "") -> Cipher:
        """Only the AES-GCM default cipher is implemented; a config
        selecting another cipher must raise, not silently differ."""
        if config_fname:
            import os as _os

            if not _os.path.exists(config_fname):
                raise FileNotFoundError(config_fname)
            cfg = open(config_fname).read().lower()
            if "gcm" not in cfg:
                raise NotImplementedError(
                    f"cipher config {config_fname!r} selects a non-GCM "
                    f"cipher; only AES-GCM is implemented")
        return Cipher()

    CreateCipher = create_cipher


class CipherUtils:
    @staticmethod
    def gen_key(length: int = 256) -> bytes:
        """``length`` in BITS (reference GenKey semantics)."""
        if length % 8:
            raise ValueError("key length must be a multiple of 8 bits")
        return os.urandom(length // 8)

    @staticmethod
    def gen_key_to_file(length: int, filename: str) -> bytes:
        key = CipherUtils.gen_key(length)
        with open(filename, "wb") as f:
            f.write(key)
        return key

    @staticmethod
    def read_key_from_file(filename: str) -> bytes:
        with open(filename, "rb") as f:
            return f.read()

    GenKey = gen_key
    GenKeyToFile = gen_key_to_file
    ReadKeyFromFile = read_key_from_file
