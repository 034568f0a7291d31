/* crc32c (Castagnoli) — slice-by-8, used by the TFRecord codec.
 *
 * The reference leans on TensorFlow's record writer (DataGeneration/
 * makeTFRecord.py:58-62); this framework ships its own TF-free codec, and
 * the per-byte CRC is the only part that needs native speed. Built once by
 * skyhdr_torch.native.build (cc -O3 -shared) and loaded via ctypes.
 */

#include <stdint.h>
#include <stddef.h>

static uint32_t table[8][256];
static int initialized = 0;

static void init_tables(void) {
    const uint32_t poly = 0x82f63b78u; /* reflected CRC-32C polynomial */
    for (int i = 0; i < 256; i++) {
        uint32_t crc = (uint32_t)i;
        for (int j = 0; j < 8; j++)
            crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
        table[0][i] = crc;
    }
    for (int i = 0; i < 256; i++)
        for (int s = 1; s < 8; s++)
            table[s][i] = (table[s - 1][i] >> 8) ^ table[0][table[s - 1][i] & 0xff];
    initialized = 1;
}

uint32_t skyhdr_crc32c(const uint8_t *data, size_t len, uint32_t seed) {
    if (!initialized) init_tables();
    uint32_t crc = ~seed;
    while (len >= 8) {
        crc ^= (uint32_t)data[0] | ((uint32_t)data[1] << 8) |
               ((uint32_t)data[2] << 16) | ((uint32_t)data[3] << 24);
        uint32_t next = (uint32_t)data[4] | ((uint32_t)data[5] << 8) |
                        ((uint32_t)data[6] << 16) | ((uint32_t)data[7] << 24);
        crc = table[7][crc & 0xff] ^ table[6][(crc >> 8) & 0xff] ^
              table[5][(crc >> 16) & 0xff] ^ table[4][crc >> 24] ^
              table[3][next & 0xff] ^ table[2][(next >> 8) & 0xff] ^
              table[1][(next >> 16) & 0xff] ^ table[0][next >> 24];
        data += 8;
        len -= 8;
    }
    while (len--) crc = (crc >> 8) ^ table[0][(crc ^ *data++) & 0xff];
    return ~crc;
}
