// Bitwise-faithful replication of the reference's GLM solve, compiled with
// the same optimization flags so floating-point contraction (FMA) decisions
// match the reference binary's.
//
// GLM::train (GLM.cpp:20-23): w = pinv(X^T X) * X^T * y, with
// Matrix::operator*'s `curSum = curSum + a[i][k]*b[k][j]` accumulation
// (Matrix.cpp:76-96), pseudoInverse(A) = gaussJordanInverse(A^T A) * A^T
// for the square normal matrix (Matrix.cpp:209-221), and the reference's
// Gauss-Jordan elimination ordering (Matrix.cpp:109-207).
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// rows x cols row-major multiply with the reference accumulation order
void mat_mul(const double* a, int64_t n, int64_t m, const double* b,
             int64_t p, double* out) {
    for (int64_t i = 0; i < n; i++) {
        for (int64_t j = 0; j < p; j++) {
            double cur = 0;
            for (int64_t k = 0; k < m; k++)
                cur = cur + a[i * m + k] * b[k * p + j];
            out[i * p + j] = cur;
        }
    }
}

void transpose(const double* a, int64_t n, int64_t m, double* out) {
    for (int64_t i = 0; i < n; i++)
        for (int64_t j = 0; j < m; j++) out[j * n + i] = a[i * m + j];
}

// Matrix::gaussJordanInverse; returns false when the reference would print
// "Inverse does not exist" (and returns the original matrix)
bool gj_inverse(double* m, int64_t n, double* inv) {
    std::vector<double> orig(m, m + n * n);
    for (int64_t i = 0; i < n * n; i++) inv[i] = 0;
    for (int64_t i = 0; i < n; i++) inv[i * n + i] = 1;
    for (int64_t i = 0; i < n; i++) {
        if (m[i * n + i] != 1.0) {
            if (m[i * n + i] != 0.0) {
                double pivot = m[i * n + i];
                for (int64_t j = 0; j < n; j++) {
                    m[i * n + j] = m[i * n + j] / pivot;
                    inv[i * n + j] = inv[i * n + j] / pivot;
                }
            } else {
                bool proper = false;
                int64_t row = i + 1;
                while (!proper && row < n) {
                    if (m[row * n + i] != 0.0) proper = true;
                    else row++;
                }
                if (proper) {
                    for (int64_t j = 0; j < n; j++) {
                        std::swap(m[i * n + j], m[row * n + j]);
                        std::swap(inv[i * n + j], inv[row * n + j]);
                    }
                } else {
                    std::memcpy(inv, orig.data(), n * n * sizeof(double));
                    return false;
                }
                double pivot = m[i * n + i];
                for (int64_t j = 0; j < n; j++) {
                    m[i * n + j] = m[i * n + j] / pivot;
                    inv[i * n + j] = inv[i * n + j] / pivot;
                }
            }
        }
        for (int64_t below = i + 1; below < n; below++) {
            if (m[below * n + i] != 0.0) {
                double pivot = m[below * n + i];
                for (int64_t j = 0; j < n; j++) {
                    m[below * n + j] = m[below * n + j] - pivot * m[i * n + j];
                    inv[below * n + j] =
                        inv[below * n + j] - pivot * inv[i * n + j];
                }
            }
        }
    }
    for (int64_t i = n - 1; i >= 0; i--) {
        for (int64_t above = 0; above < i; above++) {
            if (m[above * n + i] != 0.0) {
                double pivot = m[above * n + i];
                for (int64_t j = 0; j < n; j++) {
                    m[above * n + j] = m[above * n + j] - pivot * m[i * n + j];
                    inv[above * n + j] =
                        inv[above * n + j] - pivot * inv[i * n + j];
                }
            }
        }
    }
    for (int64_t i = 0; i < n; i++)
        for (int64_t j = 0; j < n; j++) {
            if (i == j && m[i * n + j] != 1.0) {
                std::memcpy(inv, orig.data(), n * n * sizeof(double));
                return false;
            }
            if (i != j && m[i * n + j] != 0.0) {
                std::memcpy(inv, orig.data(), n * n * sizeof(double));
                return false;
            }
        }
    return true;
}

}  // namespace

extern "C" {

// X: [n, m] row-major; y: [n]; w_out: [m].  Returns 0.
int glm_train_ref(const double* X, int64_t n, int64_t m, const double* y,
                  double* w_out) {
    std::vector<double> xt(m * n);
    transpose(X, n, m, xt.data());
    std::vector<double> xtx(m * m);
    mat_mul(xt.data(), m, n, X, m, xtx.data());
    // pseudoInverse(xtx): square -> gj_inverse(xtx^T * xtx) * xtx^T
    std::vector<double> xtxt(m * m);
    transpose(xtx.data(), m, m, xtxt.data());
    std::vector<double> tbo(m * m);
    mat_mul(xtxt.data(), m, m, xtx.data(), m, tbo.data());
    std::vector<double> gj(m * m);
    gj_inverse(tbo.data(), m, gj.data());
    std::vector<double> pinv(m * m);
    mat_mul(gj.data(), m, m, xtxt.data(), m, pinv.data());
    // w = (pinv * X^T) * y  (left associative, GLM.cpp:22)
    std::vector<double> pxt(m * n);
    mat_mul(pinv.data(), m, m, xt.data(), n, pxt.data());
    mat_mul(pxt.data(), m, n, y, 1, w_out);
    return 0;
}

}  // extern "C"
