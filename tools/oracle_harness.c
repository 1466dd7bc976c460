/* Oracle harness: drive internal functions of the reference decoder
 * (built from /root/reference/Decoder/src, see tools/build_oracle.sh)
 * so unit tests can validate this decoder's entropy tables and parsers
 * block-by-block instead of only end-to-end.
 *
 * Usage (one request per line on stdin, answers on stdout):
 *   cavlc <nc> <maxNumCoeff> <hexbytes>
 *       -> "ok <totalCoeff> <consumedBits> <c0> ... <c15>"  or  "err"
 *          (reference h264bsd_cavlc.c:748 h264bsdDecodeResidualBlockCavlc)
 *   ue <hexbytes>  / se <hexbytes>
 *       -> "ok <value> <consumedBits>" or "err"
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "basetype.h"
#include "h264bsd_stream.h"
#include "h264bsd_cavlc.h"
#include "h264bsd_vlc.h"

static int hex2buf(const char *hex, u8 *buf, int maxn) {
    int n = 0;
    while (hex[0] && hex[1] && n < maxn) {
        unsigned v;
        if (sscanf(hex, "%2x", &v) != 1) return -1;
        buf[n++] = (u8)v;
        hex += 2;
    }
    return n;
}

int main(void) {
    char line[4096];
    while (fgets(line, sizeof line, stdin)) {
        char cmd[16], hex[2048];
        u8 buf[512];
        strmData_t strm;
        if (sscanf(line, "%15s", cmd) != 1) continue;
        if (!strcmp(cmd, "cavlc")) {
            int nc, maxNumCoeff;
            if (sscanf(line, "%*s %d %d %2047s", &nc, &maxNumCoeff, hex) != 3) {
                printf("err parse\n");
                continue;
            }
            int n = hex2buf(hex, buf, sizeof buf);
            if (n <= 0) { printf("err hex\n"); continue; }
            memset(&strm, 0, sizeof strm);
            strm.pStrmBuffStart = buf;
            strm.pStrmCurrPos = buf;
            strm.strmBuffSize = (u32)n;
            i32 coeff[16];
            memset(coeff, 0, sizeof coeff);
            u32 ret = h264bsdDecodeResidualBlockCavlc(&strm, coeff, nc,
                                                      (u32)maxNumCoeff);
            if (ret == 1 /* HANTRO_NOK */) {
                printf("err\n");
            } else {
                printf("ok %u %u", (ret >> 4) & 0xFF, strm.strmBuffReadBits);
                for (int i = 0; i < 16; i++) printf(" %d", coeff[i]);
                printf("\n");
            }
        } else if (!strcmp(cmd, "ue") || !strcmp(cmd, "se")) {
            if (sscanf(line, "%*s %2047s", hex) != 1) { printf("err\n"); continue; }
            int n = hex2buf(hex, buf, sizeof buf);
            if (n <= 0) { printf("err hex\n"); continue; }
            memset(&strm, 0, sizeof strm);
            strm.pStrmBuffStart = buf;
            strm.pStrmCurrPos = buf;
            strm.strmBuffSize = (u32)n;
            u32 ok;
            if (!strcmp(cmd, "ue")) {
                u32 val;
                ok = h264bsdDecodeExpGolombUnsigned(&strm, &val);
                if (ok) printf("err\n");
                else printf("ok %u %u\n", val, strm.strmBuffReadBits);
            } else {
                i32 val;
                ok = h264bsdDecodeExpGolombSigned(&strm, &val);
                if (ok) printf("err\n");
                else printf("ok %d %u\n", val, strm.strmBuffReadBits);
            }
        } else {
            printf("err unknown\n");
        }
        fflush(stdout);
    }
    return 0;
}
